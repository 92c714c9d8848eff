"""The port's patch gather (``kernels.patch_gather``, its plain version on
the CPU) and ``ops.patches.patchify_embed`` against the JAX package's
``extract_patches`` and the port's earlier ``F.unfold`` path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vipant_tpu.ops.patches import extract_patches
from vipant_tpu_torch.ops import kernels
from vipant_tpu_torch.ops.patches import patchify_embed

# (H, W), patch, stride, Cin: tests/test_patches.py's three shapes and DeiT's audio grid
SHAPES = [
    ((224, 224), (32, 32), (32, 32), 3),  # image: non-overlapping
    ((1000, 128), (32, 32), (16, 24), 1),  # audio: overlapping rect
    ((100, 128), (32, 32), (16, 16), 1),
    ((1000, 128), (16, 16), (10, 10), 1),  # DeiT's audio: a stride of 10
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,patch,stride,c", SHAPES)
def test_patch_gather_plain_matches_extract_patches(rng, hw, patch, stride, c, dtype):
    x = rng.standard_normal((2, c, *hw)).astype(np.float32)
    got = kernels.patch_gather_plain(torch.from_numpy(x), patch, stride, dtype)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(extract_patches(jnp.asarray(x.transpose(0, 2, 3, 1), jdtype), patch, stride),
                     np.float32)  # [B, L, ph*pw*c] in (h, w, c) order
    B, L, _ = ref.shape
    ref = ref.reshape(B, L, *patch, c).transpose(0, 4, 2, 3, 1).reshape(B, -1, L)  # [B, (c, h, w), L]
    assert got.dtype == dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("shape,patch,match", [
    ((1, 1000, 128), (32, 32), "B, Cin, H, W"),  # no channel dim
    ((2, 1, 1, 1000, 128), (32, 32), "B, Cin, H, W"),
    ((2, 1, 24, 128), (32, 32), "does not fit"),  # taller than the input
    ((2, 1, 1000, 24), (32, 32), "does not fit"),  # wider than the input
])
def test_patch_gather_rejects_what_it_cannot_cut(shape, patch, match):
    with pytest.raises(ValueError, match=match):
        kernels.patch_gather(torch.zeros(shape), patch, (16, 24))


@pytest.mark.parametrize("hw,patch,stride,c", SHAPES)
def test_patchify_embed_of_fp32_input_is_bitwise_the_unfold_path(rng, hw, patch, stride, c):
    """The tower no longer rounds x before the call: the gather rounds it,
    and the rows and the product are the bits of ``x.to(bf16)``, then
    ``F.unfold``, then the product with the flattened weight."""
    x = torch.from_numpy(rng.standard_normal((2, c, *hw)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, c, *patch)).astype(np.float32)).bfloat16()
    old = F.unfold(x.to(torch.bfloat16), kernel_size=patch, stride=stride)
    old = torch.matmul(old.transpose(1, 2), w.reshape(16, -1).t())
    got = patchify_embed(x, w, patch, stride)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, old)
