"""Batched inference: embeddings and zero-shot classification on one device.

Counterpart of ``vipant_tpu/serve.py:InferenceEngine`` for fbank arrays,
token ids and preprocessed images. Every encoder runs at the fixed
``batch_size`` (the last chunk is padded by repeating its last row, then
trimmed), embeddings come back L2-normalised as fp32 numpy, and zero-shot
takes the max over each class's prompts. The engine runs on the card
(``device="cuda"``, the default; it raises when there is none), where the
transformer sub-blocks run the hand-written kernels
(:mod:`vipant_tpu_torch.ops`); ``device="cpu"`` runs their plain versions.

``quantize="int8"`` runs every sub-block of every tower on the forward-only
int8 kernels (qkv, out, fc and proj products int8 x int8 -> int32, weights
per output channel, activations per token), scoped to this engine's encode
calls: a bf16 engine beside it is not affected.

A CLAP model with a captioning decoder also serves :meth:`caption`:
KV-cached greedy decoding, or beam search, to strings. Under
``quantize="int8"`` the audio tower and the decoder's self-attention and MLP
sub-blocks run int8; the cross-attention has no int8 form and stays bf16.

Not ported yet: the wav -> fbank frontend (``caption_files``) and image
preprocessing (the JAX package's data modules import JAX), the HTTP server,
``.pth`` / CLIP weight loading and multi-device sharding.

Usage::

    from vipant_tpu_torch.serve import InferenceEngine
    eng = InferenceEngine([...overrides..., "worker=CLAP"], batch_size=64)   # on the card
    a = eng.embed_audio(fbanks)              # [N, D]
    t = eng.embed_texts(["a dog barking"])   # [N, D]
    eng8 = InferenceEngine([...], batch_size=64, quantize="int8")
    cap = InferenceEngine([..., "+model/text=transformer_decoder", "+model/loss=ce_lm"])
    strings = cap.caption(fbanks, beam=4)    # N captions
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .ckpt.from_jax import load_params, read_npz
from .config import Config
from .models import build_main_model, init_weights
from .nn.heads import normalize
from .ops.quant import int8_fwd_context
from .utils import as_config, require_device, run_root


class InferenceEngine:
    """Config-to-embeddings engine on one device.

    ``cfg``: a composed :class:`vipant_tpu_torch.config.Config` or a list of
    override strings. ``device`` defaults to the card. ``quantize`` is ``""``
    or ``"int8"``. ``token_pack`` packs k items per
    attention call in the image and text towers (exact; applied only when
    it divides ``batch_size``). Weights come from ``model.npz`` under
    ``model_root/model_name/model_file`` when ``model_file`` names a
    directory (the towers it leaves out from the port trainer's
    ``state.pt`` there), else from a random init seeded with ``seed``.
    """

    def __init__(
        self,
        cfg,
        batch_size: int = 64,
        device: Union[str, torch.device] = "cuda",
        token_pack: int = 4,
        seed: int = 0,
        quantize: str = "",
        data_parallel: bool = False,
        model_parallel: int = 1,
        echo: Optional[logging.Logger] = None,
    ):
        if quantize not in ("", "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (only 'int8')")
        self._int8 = bool(quantize)
        if data_parallel:
            raise NotImplementedError("data-parallel serving is not ported yet")
        if model_parallel != 1:
            raise NotImplementedError("model-parallel serving is not ported yet")
        self.echo = echo or logging.getLogger(__name__)
        self.cfg = as_config(cfg)
        self.device = require_device(device, "InferenceEngine")
        self.batch_size = int(batch_size)
        if token_pack > 1 and self.batch_size % token_pack == 0:
            # patch a copy: the caller's config may build something else later
            patched, changed = Config(self.cfg.to_dict(resolve=False)), False
            for key in ("image", "text"):
                head = patched.get("model", Config({})).get(key)
                if (
                    head is not None
                    and str(head.get("encoder", Config({})).get("name", "")) == "TransformerBackbone"
                    and head.get("token_pack", None) is None
                ):
                    head["token_pack"] = int(token_pack)
                    changed = True
            if changed:
                self.cfg = patched
        self.model = build_main_model(self.cfg, device=self.device)
        init_weights(self.model, torch.Generator(device=self.device).manual_seed(seed))
        self._load()
        self.model.eval()

    # ------------------------------------------------------------- loading
    def _load(self) -> None:
        cfg = self.cfg
        model_file = str(cfg.get("model_file", "") or "")
        if not model_file:
            self.echo.info("no model_file: serving seeded random weights")
            return
        if model_file.endswith(".pth"):
            raise NotImplementedError("reference .pth loading is not ported yet")
        ckpt_path = os.path.join(
            run_root(cfg.get("model_root", "") or ""), str(cfg.get("model_name", "") or ""), model_file
        )
        npz = os.path.join(ckpt_path, "model.npz")
        if not os.path.exists(npz):
            # random weights give plausible unit-norm embeddings: fail loudly
            raise FileNotFoundError(f"model_file {model_file!r}: no model.npz at {npz}")
        params = read_npz(npz)
        towers = [t for t in ("image", "audio", "text", "decoder")
                  if getattr(self.model, t, None) is not None]
        uncovered = [t for t in towers if t not in params]
        if uncovered:
            self._load_from_train_state(ckpt_path, npz, sorted(params), uncovered)
        load_params(self.model, params)
        self.echo.info(f"loaded weight export {npz}")

    def _load_from_train_state(self, ckpt_path: str, npz: str, covered: List[str],
                               towers: List[str]) -> None:
        """Towers a weight export leaves out (the VA trainer exports the audio
        tower and the loss head; the JAX engine seeds the rest from CLIP
        weights) come from the port trainer's ``state.pt`` in the same step
        directory, which holds every tower as it trained: the frozen ones
        too."""
        state = os.path.join(ckpt_path, "state.pt")
        if not os.path.exists(state):
            raise ValueError(
                f"{npz} covers only {covered} but the model has tower(s) {towers}, and "
                f"{ckpt_path} holds no state.pt; seeding them from CLIP weights is not ported yet")
        sd = torch.load(state, map_location="cpu", weights_only=True)
        saved = {**sd["frozen_params"], **sd["params"]}
        take = {k: v for k, v in saved.items() if k.split(".", 1)[0] in towers}
        want = {k for k, _ in self.model.named_parameters() if k.split(".", 1)[0] in towers}
        if set(take) != want:
            raise ValueError(f"{state} and the model disagree on {sorted(set(take) ^ want)}")
        self.model.load_state_dict(take, strict=False)
        self.echo.info(f"tower(s) {towers} not in {npz}: loaded from {state}")

    # --------------------------------------------------------------- encode
    def _embed_dim(self) -> int:
        """The shared embedding width: the loss head's, else any tower's."""
        model = self.cfg.model
        for group in ("loss", "image", "audio", "text"):
            node = model.get(group, None)
            d = node.get("embed_dim", None) if node is not None else None
            if d:
                return int(d)
        raise ValueError("no embed_dim found in model config")

    def _run_batched(self, method: str, arr: np.ndarray) -> np.ndarray:
        """[N, ...] host array -> fixed [batch_size, ...] device batches ->
        [N, D] fp32, normalised twice (tower, then here, clip 1e-8)."""
        if arr.shape[0] == 0:
            return np.zeros((0, self._embed_dim()), np.float32)
        fn = getattr(self.model, method)
        B = self.batch_size
        outs = []
        with torch.inference_mode(), int8_fwd_context(self._int8):
            for i in range(0, arr.shape[0], B):
                chunk = arr[i : i + B]
                n = chunk.shape[0]
                if n < B:  # pad to the fixed batch by repeating the last row
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], B - n, axis=0)])
                out = normalize(fn(torch.from_numpy(chunk).to(self.device), train=False))
                outs.append(out.float().cpu().numpy()[:n])
        return np.concatenate(outs, axis=0)

    def embed_audio(self, fbanks: np.ndarray) -> np.ndarray:
        """[N, T, M] or [N, 1, T, M] log-mel -> [N, D] normalised."""
        a = np.ascontiguousarray(fbanks, np.float32)
        if a.ndim == 3:
            a = a[:, None]
        return self._run_batched("encode_audio", a)

    def embed_texts(self, texts: Sequence[str], prompt: str = "") -> np.ndarray:
        """Strings -> BPE ids (fixed ctx padding) -> [N, D] normalised."""
        from .tokenizer import tokenize

        ctx = int(self.cfg.model.text.get("ctx_len", 77))
        ids = tokenize([f"{prompt}{t}" for t in texts], context_length=ctx)
        return self._run_batched("encode_text", ids.astype(np.int64))

    def embed_images(self, images: np.ndarray) -> np.ndarray:
        """[N, 3, H, W] CLIP-preprocessed images -> [N, D] normalised."""
        return self._run_batched("encode_image", np.ascontiguousarray(images, np.float32))

    # ------------------------------------------------------------ captioning
    def caption(self, fbanks: np.ndarray, beam: int = 0) -> List[str]:
        """[N, T, M] or [N, 1, T, M] log-mel -> N caption strings: KV-cached
        greedy decoding, or beam search with ``beam`` > 1. Needs a captioning
        model (CLAP with a SeqGenerationHead decoder)."""
        from .tokenizer import detokenize_ids

        if getattr(self.model, "decoder", None) is None:
            raise ValueError("caption needs a captioning model: CLAP with "
                             "model.text.name=SeqGenerationHead")
        a = np.ascontiguousarray(fbanks, np.float32)
        if a.ndim == 3:
            a = a[:, None]
        B = self.batch_size
        out: List[str] = []
        with torch.inference_mode(), int8_fwd_context(self._int8):
            for i in range(0, a.shape[0], B):
                chunk = a[i : i + B]
                n = chunk.shape[0]
                if n < B:  # pad to the fixed batch by repeating the last row
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], B - n, axis=0)])
                ids, _ = self.model.decode(torch.from_numpy(chunk).to(self.device), beam=int(beam))
                out.extend(detokenize_ids(row) for row in ids.cpu().numpy()[:n])
        return out

    # ------------------------------------------------------------ zero-shot
    def zero_shot(
        self,
        fbanks: np.ndarray,
        class_prompts: Dict[str, Sequence[str]],
        temperature: float = 100.0,
    ) -> Dict[str, Any]:
        """Multi-prompt zero-shot: prompts are scored and collapsed per class
        by their max; probabilities are softmax(temperature * score)."""
        classes = list(class_prompts)
        flat, owner = [], []
        for ci, c in enumerate(classes):
            if not class_prompts[c]:
                raise ValueError(f"class {c!r} has no prompts")
            flat.extend(class_prompts[c])
            owner.extend([ci] * len(class_prompts[c]))
        t = self.embed_texts(flat)
        a = self.embed_audio(fbanks)
        sims = a @ t.T  # [N, P]
        owner_arr = np.asarray(owner)
        per_class = np.stack(
            [sims[:, owner_arr == ci].max(axis=1) for ci in range(len(classes))], axis=1
        )
        return {
            "classes": classes,
            "scores": per_class,
            "probs": _softmax(per_class * temperature),
            "prediction": [classes[i] for i in per_class.argmax(axis=1)],
        }


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
