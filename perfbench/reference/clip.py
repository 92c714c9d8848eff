"""A plain float32 reference of the CLIP-style towers that VIP-ANT trains and
serves, written from the published description and independent of the port.

- ViT tower (CLIP ViT-B/32; the audio tower is the same ViT over a 1-channel
  log-mel "image" with overlapping patches, its 3-channel patch kernel
  averaged over channels): patches by ``unfold`` and one product, class token,
  positional embedding, LayerNorm, pre-LN blocks ``x + attn(ln_1(x))``,
  ``x + mlp(ln_2(x))`` with QuickGELU, LayerNorm of the class token, projection.
- Text tower (CLIP's causal transformer): token and positional embeddings, the
  same blocks behind a causal mask, final LayerNorm, the end-of-text row (the
  largest id), projection.
- InfoNCE: both embeddings L2-normalised, ``min(exp(s), scale_max) * a . b^T``,
  cross-entropy over rows plus over columns.
- LARS with global-norm clipping and the warmup-cosine schedule of VIP-ANT's
  ``optimizer/standard.yaml`` (weights: trust ratio ``eta |p| / |g + wd p|``,
  ``lr * lr_weight``; biases and gains: ``lr * lr_bias``; heavy-ball momentum).

Every product goes through :func:`mm` and every activation that the program
keeps in its compute type through :func:`act`: float32 with TF32 off, or, as
the control of the checks, each product's operands and each such activation
rounded to float8 e4m3 with one scale per row (the precision below the
configuration's bfloat16). A training step is
computed in row chunks with the embeddings' gradient cached, which gives the
full batch's gradient exactly, so the released batch fits the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def set_exact_float32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per row (last dim), the
    gradient passed straight through."""
    amax = x.detach().abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """``a @ b`` (batched), in float32 or with both operands in float8."""
    if precision == "fp8":
        a = _fp8_rows(a)
        b = _fp8_rows(b.transpose(-1, -2)).transpose(-1, -2)
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return torch.matmul(a, b)


def act(x: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """An activation where the program keeps it in its compute type: as it
    is in float32, rounded to float8 in the control."""
    return _fp8_rows(x) if precision == "fp8" else x


# ---------------------------------------------------------------- the model


class Leaf(NamedTuple):
    """A parameter drawn as ``mean + std * z``: ``z`` a standard normal, or,
    with ``tail``, its cube over sqrt(15), of unit variance and heavy tails
    (kurtosis 46), as trained transformers' product weights have them."""
    name: str
    shape: tuple
    mean: float
    std: float
    tail: bool = False


def vit_spec(prefix: str, t: dict, embed_dim: int) -> List[Leaf]:
    """A ViT tower's parameters."""
    C, L, (ph, pw), cin = int(t["width"]), int(t["layers"]), t["patch"], int(t["in_channels"])
    grid = vit_grid(t)
    spec = [Leaf(f"{prefix}.misc.positional_embedding", (grid[0] * grid[1] + 1, C), 0.0, C ** -0.5),
            Leaf(f"{prefix}.misc.class_embedding", (C,), 0.0, C ** -0.5),
            Leaf(f"{prefix}.pre_encoder.conv1.weight", (C, cin, ph, pw), 0.0, (cin * ph * pw) ** -0.5)]
    spec += _ln(f"{prefix}.pre_encoder.ln", C) + _blocks(f"{prefix}.encoder", C, L)
    spec += [Leaf(f"{prefix}.post_encoder.proj", (C, embed_dim), 0.0, C ** -0.5)]
    return spec + _ln(f"{prefix}.post_encoder.ln", C)


def text_spec(prefix: str, t: dict, embed_dim: int) -> List[Leaf]:
    C, L = int(t["width"]), int(t["layers"])
    spec = [Leaf(f"{prefix}.misc.positional_embedding", (int(t["ctx_len"]), C), 0.0, 0.01),
            Leaf(f"{prefix}.pre_encoder.token_embedding.weight", (int(t["vocab_size"]), C), 0.0, 0.02)]
    spec += _blocks(f"{prefix}.encoder", C, L)
    spec += [Leaf(f"{prefix}.post_encoder.proj", (C, embed_dim), 0.0, C ** -0.5)]
    return spec + _ln(f"{prefix}.post_encoder.ln", C)


def _ln(p: str, C: int):
    # gains and offsets off their init values, so that a path which drops them shows
    return [Leaf(f"{p}.weight", (C,), 1.0, 0.1), Leaf(f"{p}.bias", (C,), 0.0, 0.1)]


def _blocks(p: str, C: int, L: int):
    """Every product's weight heavy-tailed at std 1 / sqrt(fan-in), without
    CLIP's depth scaling of the output projections: each sub-block then adds
    to the residual stream as much as it carries, so a fault in any
    sub-block shows in the embeddings, as it does in trained weights; and a
    product in a lower precision meets the outliers that trained weights
    hold."""
    out = []
    for i in range(L):
        b = f"{p}.resblocks.{i}"
        out += _ln(f"{b}.ln_1", C)
        out += [Leaf(f"{b}.attn.in_proj_weight", (3 * C, C), 0.0, C ** -0.5, tail=True),
                Leaf(f"{b}.attn.in_proj_bias", (3 * C,), 0.0, 0.02),
                Leaf(f"{b}.attn.out_proj.weight", (C, C), 0.0, C ** -0.5, tail=True),
                Leaf(f"{b}.attn.out_proj.bias", (C,), 0.0, 0.02)]
        out += _ln(f"{b}.ln_2", C)
        out += [Leaf(f"{b}.mlp.c_fc.weight", (4 * C, C), 0.0, (2 * C) ** -0.5, tail=True),
                Leaf(f"{b}.mlp.c_fc.bias", (4 * C,), 0.0, 0.02),
                Leaf(f"{b}.mlp.c_proj.weight", (C, 4 * C), 0.0, (4 * C) ** -0.5, tail=True),
                Leaf(f"{b}.mlp.c_proj.bias", (C,), 0.0, 0.02)]
    return out


def vit_grid(t: dict) -> Tuple[int, int]:
    (H, W), (ph, pw), (sh, sw) = t["input"][1:], t["patch"], t["stride"]
    return (H - ph) // sh + 1, (W - pw) // sw + 1


def param_spec(cfg: dict) -> List[Leaf]:
    """Every parameter of the configuration's model. Names follow CLIP's and
    the reference checkpoints' (``<tower>.<stage>.*``)."""
    E = int(cfg["embed_dim"])
    spec = []
    for name, t in cfg["towers"].items():
        spec += text_spec(name, t, E) if t["kind"] == "text" else vit_spec(name, t, E)
    return spec + [Leaf("loss.logit_scale", (), math.log(1 / 0.07), 0.0)]


def layernorm(x, w, p, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], w[f"{p}.weight"], w[f"{p}.bias"], eps)


def linear(x, weight, bias, precision):
    return mm(x, weight.t(), precision) + bias


def block(x, w, p, heads, precision, causal=False):
    B, T, C = x.shape
    D = C // heads
    h = act(layernorm(x, w, f"{p}.ln_1"), precision)
    qkv = act(linear(h, w[f"{p}.attn.in_proj_weight"], w[f"{p}.attn.in_proj_bias"], precision), precision)
    q, k, v = qkv.view(B, T, 3, heads, D).permute(2, 0, 3, 1, 4)
    s = mm(q, k.transpose(-1, -2), precision) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
    o = act(mm(torch.softmax(s, dim=-1), v, precision).transpose(1, 2).reshape(B, T, C), precision)
    x = act(x + linear(o, w[f"{p}.attn.out_proj.weight"], w[f"{p}.attn.out_proj.bias"], precision), precision)
    h = act(layernorm(x, w, f"{p}.ln_2"), precision)
    a = linear(h, w[f"{p}.mlp.c_fc.weight"], w[f"{p}.mlp.c_fc.bias"], precision)
    a = act(a * torch.sigmoid(1.702 * a), precision)
    return act(x + linear(a, w[f"{p}.mlp.c_proj.weight"], w[f"{p}.mlp.c_proj.bias"], precision), precision)


def vit_tower(w, p: str, t: dict, x: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """[B, Cin, H, W] -> [B, embed_dim], not normalised."""
    kernel = w[f"{p}.pre_encoder.conv1.weight"]
    if x.shape[1] != kernel.shape[1]:
        kernel = kernel.mean(dim=1, keepdim=True)
    cols = F.unfold(x.float(), kernel_size=tuple(t["patch"]), stride=tuple(t["stride"]))
    h = act(mm(cols.transpose(1, 2), kernel.reshape(kernel.shape[0], -1).t(), precision), precision)
    cls = w[f"{p}.misc.class_embedding"].expand(h.shape[0], 1, -1)
    h = torch.cat([cls, h], dim=1) + w[f"{p}.misc.positional_embedding"]
    h = act(layernorm(h, w, f"{p}.pre_encoder.ln"), precision)
    for i in range(int(t["layers"])):
        h = block(h, w, f"{p}.encoder.resblocks.{i}", int(t["heads"]), precision)
    return mm(act(layernorm(h[:, 0], w, f"{p}.post_encoder.ln"), precision), w[f"{p}.post_encoder.proj"],
              precision)


def text_tower(w, p: str, t: dict, ids: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """[B, ctx] token ids -> [B, embed_dim], not normalised."""
    ids = ids.long()
    h = act(w[f"{p}.pre_encoder.token_embedding.weight"][ids] + w[f"{p}.misc.positional_embedding"], precision)
    for i in range(int(t["layers"])):
        h = block(h, w, f"{p}.encoder.resblocks.{i}", int(t["heads"]), precision, causal=True)
    h = act(layernorm(h, w, f"{p}.post_encoder.ln"), precision)
    h = h[torch.arange(h.shape[0], device=h.device), ids.argmax(dim=-1)]
    return mm(h, w[f"{p}.post_encoder.proj"], precision)


def tower(w, name: str, t: dict, x: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    fn = text_tower if t["kind"] == "text" else vit_tower
    return fn(w, name, t, x, precision)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-8)


def infonce(a, b, logit_scale, scale_max, precision="fp32", rows: Optional[int] = None):
    """Symmetric cross-entropy of normalised ``a``, ``b``; ``rows`` keeps the
    first rows only (the check's half-batch fault)."""
    if rows is not None:
        a, b = a[:rows], b[:rows]
    logits = torch.clamp(torch.exp(logit_scale), max=scale_max) * mm(a, b.t(), precision)
    labels = torch.arange(a.shape[0], device=a.device)
    return F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)


# ------------------------------------------------------------------ serving


@torch.no_grad()
def embed(w, name: str, t: dict, x: torch.Tensor, chunk: int, precision: str = "fp32") -> torch.Tensor:
    """A tower's embeddings, normalised twice as the engine returns them."""
    out = [normalize(normalize(tower(w, name, t, x[i:i + chunk], precision)))
           for i in range(0, x.shape[0], chunk)]
    return torch.cat(out)


# ----------------------------------------------------------------- training


def loss_and_grads(cfg: dict, w: Dict[str, torch.Tensor], trainable: Sequence[str], batch: dict,
                   chunk: int, precision: str = "fp32", rows: Optional[int] = None):
    """(loss, name -> grad) of the contrastive loss over the whole batch:
    embeddings of every row without autograd, the loss and its gradient with
    respect to the trained tower's embeddings, then each row chunk's forward
    again with that gradient pushed through it."""
    (na, ta), (nb, tb) = cfg["towers"].items()
    train_name = na if not ta["frozen"] else nb
    B = next(iter(batch.values())).shape[0]
    with torch.no_grad():
        emb = {n: torch.cat([tower(w, n, t, batch[n][i:i + chunk], precision)
                             for i in range(0, B, chunk)]) for n, t in cfg["towers"].items()}
    raw = emb[train_name].requires_grad_(True)
    scale = w["loss.logit_scale"].detach().clone().requires_grad_(True)
    e = {n: normalize(raw) if n == train_name else normalize(v) for n, v in emb.items()}
    loss = infonce(e[na], e[nb], scale, float(cfg["scale_max"]), precision, rows)
    d_raw, d_scale = torch.autograd.grad(loss, [raw, scale])
    leaves = {n: w[n].detach().requires_grad_(True) for n in trainable if n != "loss.logit_scale"}
    view = dict(w)
    view.update(leaves)
    grads = {n: torch.zeros_like(v) for n, v in leaves.items()}
    t = cfg["towers"][train_name]
    for i in range(0, B, chunk):
        out = tower(view, train_name, t, batch[train_name][i:i + chunk], precision)
        part = torch.autograd.grad(out, list(leaves.values()), d_raw[i:i + chunk], allow_unused=True)
        for n, g in zip(leaves, part):
            if g is not None:
                grads[n] += g
    grads["loss.logit_scale"] = d_scale
    return loss.detach(), grads


def lars_schedule(opt: dict, batch_size: int, count: int, steps_per_epoch: int) -> float:
    """The warmup-cosine rate at update ``count``: base ``batch / 256``, linear
    warmup over ``warmup_epoch`` epochs, cosine to ``end_lr_ratio`` of it,
    held past the last step."""
    base = batch_size / 256.0
    warm = int(opt["warmup_epoch"]) * steps_per_epoch
    total = max(int(opt["epochs"]) * steps_per_epoch, 1)
    if count < warm:
        return base * count / max(warm, 1)
    t = max(total - warm, 1)
    q = 0.5 * (1.0 + math.cos(math.pi * min(max(count - warm, 0), t) / t))
    return base * q + base * float(opt["end_lr_ratio"]) * (1.0 - q)


@torch.no_grad()
def lars_update(opt: dict, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                momentum: Dict[str, torch.Tensor], lr: float) -> float:
    """Clip by the global norm, then one LARS update in place; returns the
    norm before clipping."""
    norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).item()
    clip = float(opt["max_norm"]) / norm if norm >= float(opt["max_norm"]) else 1.0
    for n, p in params.items():
        g = grads[n] * clip
        v = momentum.setdefault(n, torch.zeros_like(p))
        if p.dim() > 1 and not n.endswith("bias"):
            d = g + float(opt["weight_decay"]) * p
            pn, dn = torch.linalg.vector_norm(p), torch.linalg.vector_norm(d)
            q = float(opt["eta"]) * pn / dn if pn > 0 and dn > 0 else torch.ones((), device=p.device)
            v.mul_(float(opt["momentum"])).add_(lr * float(opt["lr_weight"]) * q * d)
        else:
            v.mul_(float(opt["momentum"])).add_(lr * float(opt["lr_bias"]) * g)
        p.sub_(v)
    return norm


def train_readings(cfg: dict, w: Dict[str, torch.Tensor], batches: Sequence[dict], first_count: int,
                   steps_per_epoch: int, chunk: int, precision: str = "fp32",
                   rows: Optional[int] = None) -> dict:
    """Train from ``w`` (changed in place) over ``batches`` from update
    ``first_count`` on. Returns what the checks compare: each step's loss,
    each trained leaf's norm of its first update (the optimizer's state after
    one step), of its first gradient as the optimizer gets it (clipped by the
    global norm), and of its change after the last step."""
    trainable = trainable_names(cfg)
    params = {n: w[n] for n in trainable}
    start = {n: p.clone() for n, p in params.items()}
    momentum: Dict[str, torch.Tensor] = {}
    out = {"loss": [], "state": {}, "grad": {}, "change": {}}
    B = next(iter(batches[0].values())).shape[0]
    for k, batch in enumerate(batches):
        loss, grads = loss_and_grads(cfg, w, trainable, batch, chunk, precision, rows)
        out["loss"].append(float(loss))
        lr = lars_schedule(cfg["optimizer"], B, first_count + k, steps_per_epoch)
        norm = lars_update(cfg["optimizer"], params, grads, momentum, lr)
        if k == 0:
            clip = min(1.0, float(cfg["optimizer"]["max_norm"]) / norm) if norm > 0 else 1.0
            out["state"] = {n: float(torch.linalg.vector_norm(v.double())) for n, v in momentum.items()}
            out["grad"] = {n: clip * float(torch.linalg.vector_norm(g.double())) for n, g in grads.items()}
        del grads
    out["change"] = {n: float(torch.linalg.vector_norm((p - start[n]).double())) for n, p in params.items()}
    return out


def trainable_names(cfg: dict) -> List[str]:
    return [leaf.name for leaf in param_spec(cfg)
            if leaf.name == "loss.logit_scale" or not cfg["towers"][leaf.name.split(".")[0]]["frozen"]]
