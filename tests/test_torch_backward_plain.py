"""The plain backward chains of the port's fused sub-blocks and kernels
(vipant_tpu_torch/ops), independently of the JAX package: in float64 every
rounding to the activations' dtype is a no-op, so each hand-written backward
chain must be the exact derivative of its plain forward.

``torch.autograd.gradcheck`` (float64 finite differences, its default
tolerances) runs the sub-blocks' ``autograd.Function`` backward -- through
the wrappers, which take their plain versions on the CPU, and through the
``*_plain`` entry points the card's comparisons use. The kernels' plain
backward versions are held to autograd of their plain forwards at
rtol = 1e-10, atol = 1e-12."""

import pytest
import torch

from vipant_tpu_torch.nn.layers import causal_mask, pack_tokens
from vipant_tpu_torch.ops import fused_attn, fused_mlp, kernels

B, T, C, H = 2, 6, 8, 2
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is fastest, and keeps
    this file from oversubscribing the cores when the suite runs in
    several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rn(gen, *shape, std=1.0):
    return (torch.randn(*shape, generator=gen, dtype=F64) * std).requires_grad_()


def _bias(kind):
    if kind == "none":
        return None
    causal = causal_mask(T)
    pack = pack_tokens(torch.zeros(2, T // 2, 1), 2)[1]
    return causal if kind == "causal" else causal + pack


ATTN = {"wrapper": (fused_attn.fused_ln_attention_block, fused_attn.fused_attention_block),
        "plain": (fused_attn.fused_ln_attention_block_plain, fused_attn.fused_attention_block_plain)}


@pytest.mark.parametrize("entry", ["wrapper", "plain"])
@pytest.mark.parametrize("ln", [True, False], ids=["ln_residual", "bare"])
@pytest.mark.parametrize("kind", ["none", "causal", "causal_pack"])
def test_attention_block_backward_is_the_derivative(entry, ln, kind):
    g = torch.Generator().manual_seed(7 * len(entry) + 3 * ln + len(kind))
    x = _rn(g, B, T, C)
    lns, lnb = (1 + 0.1 * _rn(g, C)).detach().requires_grad_(), _rn(g, C, std=0.1)
    w = (_rn(g, 3 * C, C, std=C ** -0.5), _rn(g, 3 * C, std=0.1), _rn(g, C, C, std=C ** -0.5),
         _rn(g, C, std=0.1))
    bias = _bias(kind)
    with_ln, bare = ATTN[entry]
    if ln:
        fn = lambda *a: with_ln(*a, bias=bias, heads=H)
        inputs = (x, lns, lnb, *w)
    else:
        fn = lambda *a: bare(*a, bias=bias, heads=H)
        inputs = (x, *w)
    assert torch.autograd.gradcheck(fn, inputs)


@pytest.mark.parametrize("entry", ["wrapper", "plain"])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp_block_backward_is_the_derivative(entry, act):
    g = torch.Generator().manual_seed(len(act) + len(entry))
    E = 4 * C
    inputs = (_rn(g, B, T, C), (1 + 0.1 * _rn(g, C)).detach().requires_grad_(), _rn(g, C, std=0.1),
              _rn(g, E, C, std=C ** -0.5), _rn(g, E, std=0.1), _rn(g, C, E, std=E ** -0.5),
              _rn(g, C, std=0.1))
    op = fused_mlp.fused_ln_mlp_block if entry == "wrapper" else fused_mlp.fused_ln_mlp_block_plain
    assert torch.autograd.gradcheck(lambda *a: op(*a, act=act), inputs)


def _vjp(fn, inputs, cot):
    out = fn(*inputs)
    return torch.autograd.grad(out, inputs, cot)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("residual", [True, False])
def test_layernorm_bwd_plain_is_the_derivative(residual):
    g = torch.Generator().manual_seed(1)
    x, w, b = _rn(g, B, T, C), _rn(g, C), _rn(g, C)
    dh, res = torch.randn(B, T, C, generator=g, dtype=F64), torch.randn(B, T, C, generator=g, dtype=F64)
    dx, dw, db = _vjp(kernels.layernorm_plain, (x, w, b), dh)
    got = kernels.layernorm_bwd_plain(x.detach(), w.detach(), dh, res if residual else None)
    _close(got[0], dx + res if residual else dx)
    _close(got[1], dw)
    _close(got[2], db)


@pytest.mark.parametrize("kind", ["none", "causal_pack"])
def test_attention_bwd_plain_is_the_derivative(kind):
    g = torch.Generator().manual_seed(2)
    qkv = _rn(g, B, T, 3 * C)
    do = torch.randn(B, T, C, generator=g, dtype=F64)
    bias = fused_attn.canon_bias(_bias(kind))
    want, = _vjp(lambda q: kernels.attention_plain(q, bias, H, 0.5), (qkv,), do)
    got, rounded = kernels.attention_bwd_plain(qkv.detach(), do, bias, H, 0.5)
    _close(got, want)
    assert torch.equal(rounded, got)  # rounding to float64 is a no-op


@pytest.mark.parametrize("act", ["none", "quick_gelu", "gelu"])
def test_gemm_backward_plain_is_the_derivative(act):
    """For ``z = act(x . w^T + b) . w2^T``: dgrad with the activation-grad
    epilogue gives d/da, then dgrad, wgrad and colsum give the data, weight
    and bias grads of the first product."""
    g = torch.Generator().manual_seed(3)
    E = 4 * C
    x, w, b, w2 = _rn(g, B, T, C), _rn(g, E, C), _rn(g, E), _rn(g, C, E)
    dz = torch.randn(B, T, C, generator=g, dtype=F64)
    zero = torch.zeros(C, dtype=F64)
    fwd = lambda x, w, b, w2: kernels.gemm_bias_act_plain(kernels.gemm_bias_act_plain(x, w, b, act),
                                                          w2, zero)
    dx, dw, db, _ = _vjp(fwd, (x, w, b, w2), dz)
    _, a = kernels.gemm_bias_act_plain(x.detach(), w.detach(), b.detach(), act, preact=True)
    da = kernels.gemm_dgrad_plain(dz, w2.detach(), False, act, None if act == "none" else a)
    _close(kernels.gemm_dgrad_plain(da, w.detach(), True), dx)
    _close(kernels.gemm_wgrad_plain(da, x.detach()), dw)
    _close(kernels.colsum_plain(da), db)
