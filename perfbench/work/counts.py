"""Operations and bytes of the work a training step or an engine batch needs,
counted from the configuration's shapes, and the least time the card could
take for it.

Each op of the model's mathematics is counted once: its products' FLOPs, its
inputs read once and its outputs written once, at the width the program
keeps them (activations and their gradients bfloat16, parameters, their
gradients and the optimizer's state float32), with no recomputation. The
backward of a product is its two products (data and weight gradient), the
backward of attention its four (dV, dP, dQ, dK) from the stored row
statistics; elementwise work between products (QuickGELU, residual adds,
biases) rides in the products' epilogues and adds nothing; token packing's
masked-out scores are not work, and a causal mask halves the scores. A
frozen tower runs forward only.

The least time of an op is the larger of its FLOPs over the peak rate of its
type and its bytes over the memory rate; a step's least time is their sum.
Published peaks of one H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s
bf16, 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s of HBM3, at the
card's 700 W limit.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from ..reference.clip import vit_grid, vit_spec

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ACT, PARAM = 2, 4  # bytes of an activation (bfloat16) and of a parameter (float32)


class Op(NamedTuple):
    name: str
    flops: float
    bytes: float
    product: bool  # a matrix product or attention's products: counted by the MFU
    kind: str = "bf16"


def _mm(name: str, M: int, K: int, N: int, extra_in: float = 0.0, out_bytes: int = ACT,
        w_elems: int = None) -> Op:
    """[M, K] activations times a [K, N] float32 weight (``w_elems`` of them
    read), output [M, N]."""
    w = K * N if w_elems is None else w_elems
    return Op(name, 2.0 * M * K * N, M * K * ACT + w * PARAM + M * N * out_bytes + extra_in, True)


def _pass(name: str, read: float, write: float) -> Op:
    return Op(name, 0.0, read + write, False)


def _attention(B: int, T: int, C: int, causal: bool) -> float:
    """FLOPs of one attention product pass over all heads: B * H * pairs * 2D."""
    pairs = T * (T + 1) / 2 if causal else T * T
    return 2.0 * B * pairs * C


def tower_ops(t: dict, B: int, train: bool) -> List[Op]:
    """The ops of one tower over ``B`` items, forward and, when ``train``,
    backward."""
    C, L = int(t["width"]), int(t["layers"])
    text = t["kind"] == "text"
    if text and train:
        raise NotImplementedError("the backward of a text tower is not counted")
    if text:
        T = int(t["ctx_len"])
        ops = [_pass("token_embedding", B * T * 8 + B * T * C * PARAM, B * T * C * ACT)]
    else:
        (cin, hh, ww), (ph, pw) = t["input"], t["patch"]
        gh, gw = vit_grid(t)
        P, T = gh * gw, gh * gw + 1
        K = cin * ph * pw  # a 1-channel input meets the kernel's channel mean
        w_elems = int(t["in_channels"]) * ph * pw * C
        # the float32 input is read once, whatever im2col makes of it
        ops = [Op("patch_embed", 2.0 * B * P * K * C,
                  B * cin * hh * ww * 4 + w_elems * PARAM + B * P * C * ACT, True),
               _pass("embed_ln", B * P * C * ACT + T * C * PARAM, B * T * C * ACT)]
    M = B * T
    att = _attention(B, T, C, text)
    layer = [_pass("ln_1", M * C * ACT, M * C * ACT),
             _mm("qkv", M, C, 3 * C),
             Op("attention", 2 * att, 3 * M * C * ACT + M * C * ACT, True),
             _mm("out_proj", M, C, C, extra_in=M * C * ACT),
             _pass("ln_2", M * C * ACT, M * C * ACT),
             _mm("fc", M, C, 4 * C),
             _mm("proj", M, 4 * C, C, extra_in=M * C * ACT)]
    ops += layer * L
    E = int(t["embed_dim"])
    ops += [_pass("post_ln", B * C * ACT, B * C * ACT), _mm("post_proj", B, C, E)]
    if not train:
        return ops
    grads = [Op("proj_dgrad", 2.0 * M * 4 * C * C, M * C * ACT + 4 * C * C * PARAM + 2 * M * 4 * C * ACT, True),
             Op("proj_wgrad", 2.0 * M * 4 * C * C, M * 4 * C * ACT + M * C * ACT + 4 * C * C * PARAM, True),
             Op("fc_dgrad", 2.0 * M * 4 * C * C, M * 4 * C * ACT + 4 * C * C * PARAM + M * C * ACT, True),
             Op("fc_wgrad", 2.0 * M * 4 * C * C, M * 4 * C * ACT + M * C * ACT + 4 * C * C * PARAM, True),
             _pass("ln_2_bwd", 3 * M * C * ACT, M * C * ACT),
             Op("out_dgrad", 2.0 * M * C * C, M * C * ACT + C * C * PARAM + M * C * ACT, True),
             Op("out_wgrad", 2.0 * M * C * C, 2 * M * C * ACT + C * C * PARAM, True),
             Op("attention_bwd", 4 * att, 5 * M * C * ACT + 3 * M * C * ACT, True),
             Op("qkv_dgrad", 2.0 * M * 3 * C * C, 3 * M * C * ACT + 3 * C * C * PARAM + M * C * ACT, True),
             Op("qkv_wgrad", 2.0 * M * 3 * C * C, 3 * M * C * ACT + M * C * ACT + 3 * C * C * PARAM, True),
             _pass("ln_1_bwd", 3 * M * C * ACT, M * C * ACT)]
    ops += grads * L
    ops += [Op("post_proj_grads", 4.0 * B * C * E, 2 * B * C * ACT + B * E * ACT + C * E * PARAM, True),
            _pass("embed_ln_bwd", 2 * M * C * ACT, B * P * C * ACT + T * C * PARAM)]
    ops.append(Op("patch_wgrad", 2.0 * B * P * K * C,
                      B * cin * hh * ww * ACT + B * P * C * ACT + w_elems * PARAM, True))
    return ops


def trainable_params(t: dict) -> int:
    """Parameters of a trained ViT tower (the LARS update's reads and writes)."""
    n = 0
    for leaf in vit_spec("t", t, int(t["embed_dim"])):
        k = 1
        for d in leaf.shape:
            k *= d
        n += k
    return n


def train_step_ops(cfg: dict, B: int) -> List[Op]:
    """A contrastive training step: every tower forward, the trained one
    backward too, the loss both ways, and the optimizer's pass over the
    trained parameters (read p, g, momentum; write p, momentum)."""
    ops: List[Op] = []
    for t in cfg["towers"].values():
        ops += tower_ops(t, B, train=not t["frozen"])
    E = int(cfg["embed_dim"])
    ops.append(Op("loss", 3 * 2.0 * B * B * E, 4 * B * E * ACT, True))
    n = sum(trainable_params(t) for t in cfg["towers"].values() if not t["frozen"]) + 1
    ops.append(_pass("optimizer", 3 * n * PARAM, 2 * n * PARAM))
    return ops


def embed_ops(cfg: dict, tower: str, B: int) -> List[Op]:
    """An engine batch: one tower forward."""
    return tower_ops(cfg["towers"][tower], B, train=False)


def least_seconds(ops: List[Op]) -> float:
    return sum(max(op.flops / PEAK_FLOPS[op.kind], op.bytes / HBM_BYTES_PER_S) for op in ops)


def product_flops(ops: List[Op]) -> float:
    """The model's matrix-product FLOPs (what the MFU counts)."""
    return sum(op.flops for op in ops if op.product)


def summary(ops: List[Op]) -> Dict[str, float]:
    return {"least_s": least_seconds(ops), "product_flops": product_flops(ops)}
