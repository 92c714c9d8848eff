"""Weights and inputs made from the run's seed, on the device, in a few large
calls: the same seed gives the same numbers to the program and to the
reference. Each draw has a generator of its own, seeded from (seed, what,
index), so any batch can be made again for the reference after the window."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one draw, from the run's seed and the draw's path."""
    words = [int(seed) % (1 << 64)] + [int(p) for p in path]
    state = np.random.SeedSequence([w & 0xFFFFFFFF for w in words] + [w >> 32 for w in words])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *path))


WEIGHTS, BATCH = 1, 2


def make_weights(spec: Iterable, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor for each leaf of ``spec`` (the reference's
    :class:`~perfbench.reference.clip.Leaf`): one normal draw for all of
    them, each leaf a view of it."""
    spec = list(spec)
    sizes = [int(np.prod(leaf.shape, dtype=np.int64)) for leaf in spec]
    z = torch.randn(sum(sizes), generator=generator(device, seed, WEIGHTS), device=device)
    out, off = {}, 0
    for leaf, n in zip(spec, sizes):
        v = z[off:off + n].view(leaf.shape)
        if leaf.tail:
            v.pow_(3).div_(15 ** 0.5)
        out[leaf.name] = v.mul_(leaf.std).add_(leaf.mean)
        off += n
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's parameters, which must be exactly
    these names and shapes."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
        raise ValueError(f"the program's parameters differ from the benchmark's: only in the "
                         f"program {missing[:8]}, only in the benchmark {extra[:8]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: the program holds {tuple(p.shape)}, the benchmark "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])


def caption_ids(g: torch.Generator, B: int, ctx: int, vocab: int, words: Tuple[int, int],
                device) -> torch.Tensor:
    """[B, ctx] int32 ids as the tokenizer lays out a caption: start of text
    (vocab - 2), ``words`` (inclusive range) word ids in [1, vocab - 2), end of
    text (vocab - 1), zeros after."""
    lo, hi = words
    n = torch.randint(lo, hi + 1, (B, 1), generator=g, device=device)
    ids = torch.randint(1, vocab - 2, (B, ctx), generator=g, device=device)
    pos = torch.arange(ctx, device=device).expand(B, ctx)
    ids = torch.where(pos <= n, ids, torch.zeros_like(ids))
    ids[:, 0] = vocab - 2
    ids.scatter_(1, n + 1, torch.full_like(n, vocab - 1))
    return ids.to(torch.int32)


def make_batch(cfg: dict, mix: dict, seed: int, index: int, device) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of the run: tower name -> input on ``device``. Images
    and log-mels are standard normals (the scale of CLIP-normalised frames
    and of normalised fbanks), float32 as the loader ships them; token ids
    as :func:`caption_ids`."""
    g = generator(device, seed, BATCH, index)
    B, out = int(mix["batch"]), {}
    for name, t in cfg["towers"].items():
        if name not in mix["inputs"]:
            continue
        if t["kind"] == "text":
            out[name] = caption_ids(g, B, int(t["ctx_len"]), int(t["vocab_size"]),
                                    tuple(mix["words"]), device)
        else:
            out[name] = torch.randn((B, *t["input"]), generator=g, device=device)
    return out
