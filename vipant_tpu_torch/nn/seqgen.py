"""SeqGenerationHead: causal text decoder cross-attending into the audio
tower's feature grid, with greedy and beam decoding.

Counterpart of ``vipant_tpu/nn/seqgen.py``. The audio grid features are
projected into the text width (``to_txt``), averaged over the frequency
axis, layer-normed and used as cross-attention memory; training returns
(pooled text embedding, next-token logits). The JAX package's ``lax.scan``
decode loops are Python loops over fixed-size id buffers here, on the
model's device; no random numbers are drawn.

Per layer the training forward runs the fused self-attention sub-block with
the causal bias, ``ln_c``, the cross-attention (the hand-written flash
kernels, 77 queries against the memory's 61 rows at the default geometry)
and the fused MLP sub-block. :meth:`greedy_decode` re-forwards the whole
buffer every step through the same kernels; :meth:`greedy_decode_kv` and
:meth:`beam_decode_kv` forward one position per step against per-layer
caches.

Parameter names: ``token_embedding`` [vocab, width], ``positional_embedding``
[ctx, width], ``to_txt`` [mem_width, width], ``mem_ln``,
``transformer.resblocks.{i}`` (with ``ln_c`` and ``cross_attn``),
``ln_final``, ``predictor`` (a Linear) and ``text_proj`` [width, embed_dim].
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, Transformer, causal_mask

SOT_TOKEN, EOT_TOKEN = 49406, 49407


class SeqGenerationHead(nn.Module):
    def __init__(self, width: int = 512, layers: int = 12, heads: int = 8, ctx_len: int = 77,
                 vocab_size: int = 49408, embed_dim: int = 512, mem_width: int = 768,
                 max_len_dec: int = 32, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.width, self.layers, self.heads = width, layers, heads
        self.vocab_size, self.max_len_dec, self.dtype = vocab_size, max_len_dec, dtype
        self.token_embedding = nn.Parameter(torch.empty(vocab_size, width, device=device))
        self.positional_embedding = nn.Parameter(torch.empty(ctx_len, width, device=device))
        self.to_txt = nn.Parameter(torch.empty(mem_width, width, device=device))
        self.mem_ln = LayerNorm(width, device=device)
        self.transformer = Transformer(width, layers, heads, cross_attn=True, device=device)
        self.ln_final = LayerNorm(width, device=device)
        self.predictor = nn.Linear(width, vocab_size, bias=bias, device=device)
        self.text_proj = nn.Parameter(torch.empty(width, embed_dim, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        scale = self.width ** -0.5
        nn.init.normal_(self.token_embedding, std=0.02, generator=generator)
        nn.init.normal_(self.positional_embedding, std=0.01, generator=generator)
        nn.init.normal_(self.to_txt, std=scale, generator=generator)
        nn.init.normal_(self.text_proj, std=scale, generator=generator)
        # flax Dense: lecun-normal kernel (truncated, variance 1 / fan_in), zero bias
        std = self.width ** -0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.predictor.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if self.predictor.bias is not None:
            nn.init.zeros_(self.predictor.bias)

    # --------------------------------------------------------------- pieces
    def _memory(self, audio_feat: torch.Tensor, time_first: bool = True) -> torch.Tensor:
        """audio_feat: [B, rows, cols, mem_width] -> [B, T_mem, width]."""
        m = audio_feat.to(self.dtype) @ self.to_txt.to(self.dtype)
        return self.mem_ln(m.mean(dim=2 if time_first else 1))

    def _features(self, ids: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding[ids].to(self.dtype)
        x = x + self.positional_embedding[: x.shape[1]].to(self.dtype)
        x = self.transformer(x, causal_mask(x.shape[1], device=x.device), memory)
        return self.ln_final(x)

    def _predict(self, h: torch.Tensor) -> torch.Tensor:
        b = self.predictor.bias
        return F.linear(h, self.predictor.weight.to(h.dtype), None if b is None else b.to(h.dtype))

    def forward(self, ids: torch.Tensor, audio_feat: torch.Tensor, time_first: bool = True,
                normalized: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training path: (pooled embedding z, logits[:, :-1])."""
        h = self._features(ids, self._memory(audio_feat, time_first))
        logits = self._predict(h)[:, :-1]
        eot = torch.argmax(ids, dim=-1)
        z = h[torch.arange(h.shape[0], device=h.device), eot]
        z = z @ self.text_proj.to(z.dtype)
        if normalized:
            z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        return z, logits

    # --------------------------------------------------------------- decode
    def _start(self, n: int, sot_token: int, device) -> torch.Tensor:
        ids = torch.zeros((n, self.max_len_dec + 1), dtype=torch.long, device=device)
        ids[:, 0] = sot_token
        return ids

    def _init_states(self, n: int, device):
        """One fresh state per layer: empty self caches [n, L, H, D] and an
        unprojected memory."""
        shape = (n, self.max_len_dec, self.heads, self.width // self.heads)
        zeros = lambda: torch.zeros(shape, dtype=self.dtype, device=device)
        return tuple({"self": {"k": zeros(), "v": zeros(), "pos": 0}, "mem": {"k": None, "v": None}}
                     for _ in range(self.layers))

    def _one_step(self, tok: torch.Tensor, pos: int, memory: torch.Tensor, states):
        """Logits [n, vocab] of the token at ``pos`` and the new states."""
        x = self.token_embedding[tok][:, None, :].to(self.dtype)
        x = x + self.positional_embedding[pos][None, None].to(self.dtype)
        x, states = self.transformer(x, memory=memory, decode_state=states)
        return self._predict(self.ln_final(x))[:, 0], states

    @torch.no_grad()
    def greedy_decode(self, audio_feat: torch.Tensor, sot_token: int = SOT_TOKEN,
                      time_first: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decoding with a full re-forward of the id buffer per step:
        (ids [B, max_len_dec + 1], logits [B, max_len_dec, vocab])."""
        memory = self._memory(audio_feat, time_first)
        ids = self._start(audio_feat.shape[0], sot_token, audio_feat.device)
        logits = []
        for t in range(self.max_len_dec):
            h = self._features(ids[:, :-1], memory)  # [B, L, width]
            logits.append(self._predict(h[:, t]))
            ids[:, t + 1] = torch.argmax(logits[-1], dim=-1)
        return ids, torch.stack(logits, dim=1)

    @torch.no_grad()
    def greedy_decode_kv(self, audio_feat: torch.Tensor, sot_token: int = SOT_TOKEN,
                         time_first: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """KV-cached greedy decoding: each step forwards one token, appending
        its self-attention keys and values to the per-layer caches; the
        cross-attention memory is projected once, at step 0. Same ids as
        :meth:`greedy_decode` at O(L) instead of O(L^2) token-forwards."""
        memory = self._memory(audio_feat, time_first)
        n = audio_feat.shape[0]
        ids = self._start(n, sot_token, audio_feat.device)
        states = self._init_states(n, audio_feat.device)
        logits = []
        for t in range(self.max_len_dec):
            step_logits, states = self._one_step(ids[:, t], t, memory, states)
            logits.append(step_logits)
            ids[:, t + 1] = torch.argmax(step_logits, dim=-1)
        return ids, torch.stack(logits, dim=1)

    @torch.no_grad()
    def beam_decode_kv(self, audio_feat: torch.Tensor, beam: int = 4, sot_token: int = SOT_TOKEN,
                       eot_token: int = EOT_TOKEN, time_first: bool = True,
                       length_penalty: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """KV-cached beam search: ``beam`` hypotheses per item folded into
        the batch axis, the caches gathered on beam reorder, finished
        hypotheses extended only with ``eot`` at zero cost. Returns (ids
        [B, L + 1] of the best beam, its length-penalised log-prob [B]);
        ``length_penalty`` alpha normalises by ((5 + len) / 6)^alpha at the
        final ranking (0 = pure log-prob). Ties go to the lowest index."""
        device = audio_feat.device
        B, K, L, V = audio_feat.shape[0], int(beam), self.max_len_dec, self.vocab_size
        memory = self._memory(audio_feat, time_first).repeat_interleave(K, dim=0)  # [B*K, ...]
        ids = self._start(B * K, sot_token, device)
        states = self._init_states(B * K, device)
        # beams start identical: only beam 0 is alive, so the first top-k gives
        # K distinct continuations, not K copies of the argmax
        scores = torch.full((B, K), -torch.inf, device=device)
        scores[:, 0] = 0.0
        finished = torch.zeros((B, K), dtype=torch.bool, device=device)
        frozen = torch.full((V,), -torch.inf, device=device)
        frozen[eot_token] = 0.0
        rows = torch.arange(B, device=device)[:, None] * K

        def gather(t, idx):
            return t[idx] if torch.is_tensor(t) and t.dim() >= 1 and t.shape[0] == B * K else t

        for t in range(L):
            step_logits, states = self._one_step(ids[:, t], t, memory, states)
            lp = torch.log_softmax(step_logits.float(), dim=-1).view(B, K, V)
            lp = torch.where(finished[..., None], frozen, lp)
            total = (scores[..., None] + lp).view(B, K * V)
            # a stable descending sort breaks ties by the lowest index, as lax.top_k does
            order = torch.sort(total, dim=-1, descending=True, stable=True)
            scores, top = order.values[:, :K], order.indices[:, :K]
            src_beam, token = top // V, top % V
            flat_src = (rows + src_beam).reshape(-1)
            ids = ids[flat_src]
            states = tuple({name: {k: gather(v, flat_src) for k, v in part.items()}
                            for name, part in st.items()} for st in states)
            finished = torch.gather(finished, 1, src_beam)
            ids[:, t + 1] = token.reshape(-1)
            finished = finished | (token == eot_token)

        # length penalty over the generated length (first eot position)
        is_eot = ids[:, 1:].view(B, K, L) == eot_token
        lengths = torch.where(is_eot.any(dim=-1), is_eot.int().argmax(dim=-1) + 1, L).float()
        ranked = scores / ((5.0 + lengths) / 6.0) ** length_penalty
        best = torch.argmax(ranked, dim=1)
        return ids[rows[:, 0] + best], ranked[torch.arange(B, device=device), best]
