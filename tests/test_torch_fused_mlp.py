"""The port's MLP sub-block (vipant_tpu_torch/ops/fused_mlp.py) against the
JAX package's Pallas kernel in interpret mode on the CPU, both activations.
Same numpy inputs; dense kernels converted from [in, out] to torch's
[out, in]. Tolerances as in test_torch_fused_attn.py: 2e-4 for fp32 inputs,
2e-2 (one bf16 ulp plus summation order) for bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipant_tpu.ops import fused_mlp as jax_fm
from vipant_tpu_torch.ops import fused_mlp, kernels

B, C, E = 3, 64, 256
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def make(T, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (r.standard_normal(s) * std).astype(np.float32)
    return dict(
        x=f(B, T, C, std=0.5), lns=1 + f(C, std=0.1), lnb=f(C, std=0.1),
        wfc=f(C, E, std=C ** -0.5), bfc=f(E, std=0.02),
        wproj=f(E, C, std=E ** -0.5), bproj=f(C, std=0.02),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("T", [40, 37])
def test_ln_mlp_block_matches_pallas(T, act, dtype):
    p = make(T, seed=T + len(act))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    want = jax_fm.fused_ln_mlp_block(
        jnp.asarray(p["x"], getattr(jnp, dtype)),
        *(jnp.asarray(p[k]) for k in ("lns", "lnb", "wfc", "bfc", "wproj", "bproj")), act=act)
    got = fused_mlp.fused_ln_mlp_block(
        t(p["x"]).to(getattr(torch, dtype)), t(p["lns"]), t(p["lnb"]), t(p["wfc"].T),
        t(p["bfc"]), t(p["wproj"].T), t(p["bproj"]), act=act)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, T, C)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_activations_match_their_definitions():
    a = torch.linspace(-6, 6, 101, dtype=torch.float64)
    torch.testing.assert_close(kernels.act_plain(a, "quick_gelu"), a * torch.sigmoid(1.702 * a))
    torch.testing.assert_close(kernels.act_plain(a, "gelu"),
                               torch.nn.functional.gelu(a, approximate="none"))
    with pytest.raises(ValueError, match="activation"):
        fused_mlp.fused_ln_mlp_block_plain(
            torch.zeros(1, 2, C), torch.ones(C), torch.zeros(C), torch.zeros(E, C),
            torch.zeros(E), torch.zeros(C, E), torch.zeros(C), act="relu")
