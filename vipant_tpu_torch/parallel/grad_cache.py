"""Gradient cache: a large contrastive batch at one chunk's activation memory.

Counterpart of ``vipant_tpu/parallel/grad_cache.py`` (the capability behind
the reference's released "+AT w/ GC" checkpoints). Three passes:

1. **Embeddings**, under ``torch.no_grad()``: each stream encoded chunk by
   chunk, so only one chunk's activations live at a time.
2. **Loss**: the contrastive loss over the whole embedding matrices (every
   rank's, gathered, under data parallelism), differentiated with respect
   to the cached embeddings and the loss head's params.
3. **Re-forward**: each chunk encoded again with autograd and its cached
   embedding cotangent pulled back to the encoder's params; the grads are
   summed over the chunks.

d loss / d params = sum over chunks of VJP(encoder, chunk) . d loss / d emb
+ d loss / d loss params, exact as long as each chunk's randomness is the
same in passes 1 and 3: :func:`grad_cache_value_and_grad` gives each chunk
its own state of the train state's generator (a chunk's draws come after
the chunks before it, so they differ across chunks), restores it for the
chunk's re-forward, and leaves the generator where pass 1 left it. A stream
whose tower is frozen is encoded once and not re-forwarded: it has no grads
to pull back.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

Encode = Callable[[torch.Tensor], torch.Tensor]


def chunk_count(batch_size: int, chunk_size: int, ranks: int = 1) -> int:
    """The JAX trainer's rule (``vipant_tpu/train/trainer.py:369-374``): the
    smallest chunk count whose chunks hold at most ``chunk_size`` items and
    divide the global batch. Each of ``ranks`` ranks splits its share into
    as many chunks, so they must divide that share too (``ValueError``)."""
    n = max(-(-batch_size // max(chunk_size, 1)), 1)
    while batch_size % n:
        n += 1
    if batch_size % ranks or (batch_size // ranks) % n:
        raise ValueError(f"the gradient cache's {n} chunks do not split a rank's share of the "
                         f"batch ({batch_size} over {ranks} ranks)")
    return n


def _chunks(x: torch.Tensor, n: int) -> Sequence[torch.Tensor]:
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split into {n} chunks")
    return torch.chunk(x, n)


def grad_cache_value_and_grad(
    encode_a: Encode, encode_b: Encode,
    loss_of_embs: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    params: Mapping[str, torch.Tensor], batch_a: torch.Tensor, batch_b: torch.Tensor,
    n_chunks: int, generator: Optional[torch.Generator] = None,
    train_a: bool = True, train_b: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, name -> grad)`` of ``loss_of_embs(encode_a(batch_a),
    encode_b(batch_b))`` with respect to ``params`` (trainable; a param the
    loss does not reach gets a zero grad), with the activation memory of
    ``batch / n_chunks``. ``encode_*`` take a chunk and return its
    embeddings; ``loss_of_embs`` takes the two embedding matrices (this
    rank's rows; it gathers them itself under data parallelism).
    ``train_*``: the stream's tower has trainable params (else it is
    encoded once). ``generator``: the stream of the encoders' randomness,
    replayed per chunk."""
    names = list(params)
    streams = [(encode_a, _chunks(batch_a, n_chunks), train_a),
               (encode_b, _chunks(batch_b, n_chunks), train_b)]

    # 1. cached embeddings, chunk by chunk, each chunk's generator state kept
    states: List[List[Optional[torch.Tensor]]] = []
    embs: List[torch.Tensor] = []
    with torch.no_grad():
        for encode, chunks, _ in streams:
            st, out = [], []
            for c in chunks:
                st.append(generator.get_state() if generator is not None else None)
                out.append(encode(c))
            states.append(st)
            embs.append(torch.cat(out))
    end_state = generator.get_state() if generator is not None else None

    # 2. the loss, and its grads with respect to the embeddings and the loss head
    leaves = [e.detach().requires_grad_(True) for e in embs]
    with torch.enable_grad():
        loss = loss_of_embs(*leaves)
        got = torch.autograd.grad(loss, leaves + [params[n] for n in names], allow_unused=True)
    d_embs = got[:2]
    grads = {n: torch.zeros_like(params[n]) for n in names}
    for n, g in zip(names, got[2:]):
        if g is not None:
            grads[n] += g

    # 3. re-forward each chunk of a trained stream with its pass-1 randomness
    for (encode, chunks, trained), st, d_emb in zip(streams, states, d_embs):
        if not trained:
            continue
        for c, s, ct in zip(chunks, st, torch.chunk(d_emb, n_chunks)):
            if generator is not None:
                generator.set_state(s)
            with torch.enable_grad():
                out = encode(c)
                vjp = torch.autograd.grad(out, [params[n] for n in names], grad_outputs=ct,
                                          allow_unused=True)
            for n, g in zip(names, vjp):
                if g is not None:
                    grads[n] += g
    if generator is not None:
        generator.set_state(end_state)
    return loss.detach(), grads
