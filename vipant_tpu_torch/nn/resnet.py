"""CLIP's ModifiedResNet stages as MetaHead components.

Counterpart of ``vipant_tpu/nn/resnet.py``: the 3-conv stem, bottlenecks
whose stride is an average pool before the 1x1 expansion, and the
attention-pool head with a rectangular positional grid, in NCHW. The JAX
package computes all of it in XLA (no Pallas kernel), so here it is plain
PyTorch: ``F.conv2d``, ``F.avg_pool2d``, ``F.linear`` and a softmax.

BatchNorm is flax's (:class:`..nn.losses.BatchNorm`: momentum 0.99, eps
1e-5, the biased batch variance both to normalise and to move the running
``var``), not ``torch.nn.BatchNorm2d``, whose running variance is the
unbiased one. Its running ``mean`` / ``var`` are buffers: the JAX
``batch_stats`` collection, which the train state and its checkpoints carry.
A training forward (``train=True``) normalises by the batch and moves them,
also in a frozen tower, as the JAX step does (it applies every tower with
``train=True`` and ``mutable=["batch_stats"]``).

The submodules keep the JAX package's names (``conv1``, ``bn1``,
``layer{s}_{b}``, ``downsample_conv``, ``downsample_bn``, ``q_proj`` ...)
below the MetaHead stages ``pre_encoder``, ``encoder`` and
``post_encoder``, so :mod:`..ckpt.from_jax` only changes layouts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interp import interp_pos_grid
from .layers import lecun_normal_
from .losses import BatchNorm
from .stages import AddonEncoder, to_2tuple


def resnet_grid(resolution, down: int = 32) -> Tuple[int, int]:
    res = to_2tuple(resolution)
    return (res[0] // down, res[1] // down)


class Conv(nn.Module):
    """A bias-free convolution (flax ``nn.Conv(use_bias=False)``), OIHW
    weight, run in the input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), stride=self.stride, padding=self.padding)


class Dense(nn.Linear):
    """flax ``nn.Dense``: lecun-normal weight, zero bias, run in the
    input's dtype."""

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def _bn_relu(bn: BatchNorm, x: torch.Tensor, train: bool, relu: bool = True) -> torch.Tensor:
    y = bn(x, train=train).to(x.dtype)
    return torch.relu(y) if relu else y


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> (avg pool when strided) -> 1x1 (x4), BatchNorm and ReLU
    between; the shortcut is the identity or avg pool + 1x1 + BatchNorm."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, device=None):
        super().__init__()
        self.stride = stride
        out = planes * self.expansion
        self.conv1 = Conv(inplanes, planes, 1, device=device)
        self.bn1 = BatchNorm(planes, device=device)
        self.conv2 = Conv(planes, planes, 3, padding=1, device=device)
        self.bn2 = BatchNorm(planes, device=device)
        self.conv3 = Conv(planes, out, 1, device=device)
        self.bn3 = BatchNorm(out, device=device)
        if stride > 1 or inplanes != out:
            self.downsample_conv = Conv(inplanes, out, 1, device=device)
            self.downsample_bn = BatchNorm(out, device=device)
        else:
            self.downsample_conv = self.downsample_bn = None

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.stride) if self.stride > 1 else x

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = _bn_relu(self.bn1, self.conv1(x), train)
        out = self._pool(_bn_relu(self.bn2, self.conv2(out), train))
        out = _bn_relu(self.bn3, self.conv3(out), train, relu=False)
        identity = x
        if self.downsample_conv is not None:
            identity = _bn_relu(self.downsample_bn, self.downsample_conv(self._pool(x)), train,
                                relu=False)
        return torch.relu(out + identity)


class ResNetPreEncoder(nn.Module):
    """The 3-conv stem (stride 2, then two 3x3) and a 2x2 average pool. A
    1-channel input is the channel mean broadcast to ``in_channels``."""

    def __init__(self, width: int, in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.in_channels, self.dtype = in_channels, dtype
        self.conv1 = Conv(in_channels, width // 2, 3, stride=2, padding=1, device=device)
        self.bn1 = BatchNorm(width // 2, device=device)
        self.conv2 = Conv(width // 2, width // 2, 3, padding=1, device=device)
        self.bn2 = BatchNorm(width // 2, device=device)
        self.conv3 = Conv(width // 2, width, 3, padding=1, device=device)
        self.bn3 = BatchNorm(width, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"expected a 4-d input, got {tuple(x.shape)}")
        x = x.to(self.dtype)
        if x.shape[1] != self.in_channels:
            x = x.mean(dim=1, keepdim=True).expand(-1, self.in_channels, -1, -1)
        x = _bn_relu(self.bn1, self.conv1(x), train)
        x = _bn_relu(self.bn2, self.conv2(x), train)
        x = _bn_relu(self.bn3, self.conv3(x), train)
        return F.avg_pool2d(x, 2)


class ResNetBackbone(nn.Module):
    """Four bottleneck stages (``layers`` blocks each; the first block of
    stages 2-4 strided), named ``layer{stage}_{block}`` as in JAX."""

    def __init__(self, layers: Sequence[int], width: int, device=None):
        super().__init__()
        self.names = []
        inplanes = width
        for stage, blocks in enumerate(layers):
            planes = width * 2 ** stage
            for b in range(int(blocks)):
                name = f"layer{stage + 1}_{b}"
                stride = 2 if stage > 0 and b == 0 else 1
                self.add_module(name, Bottleneck(inplanes, planes, stride, device=device))
                self.names.append(name)
                inplanes = planes * Bottleneck.expansion

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x, train=train)
        return x


class ResNetPostEncoder(nn.Module):
    """The attention pool: the grid's mean token as the one query over the
    [mean, grid] tokens, positional embedding re-gridded from
    ``stored_grid`` to the input's grid at every forward; fp32 softmax."""

    def __init__(self, embed_dim: int, output_dim: int, heads: int,
                 stored_grid: Tuple[int, int], device=None):
        super().__init__()
        self.heads, self.stored_grid = heads, tuple(stored_grid)
        n = self.stored_grid[0] * self.stored_grid[1] + 1
        self.positional_embedding = nn.Parameter(torch.empty(n, embed_dim, device=device))
        for name in ("q_proj", "k_proj", "v_proj"):
            self.add_module(name, Dense(embed_dim, embed_dim, device=device))
        self.c_proj = Dense(embed_dim, output_dim, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        d = self.positional_embedding.shape[1]
        nn.init.normal_(self.positional_embedding, std=d ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        B, C, H, W = x.shape
        pos = interp_pos_grid(self.positional_embedding, self.stored_grid, (H, W), n_prefix=1)
        x = x.flatten(2).transpose(1, 2)  # [B, HW, C]
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + pos.to(x.dtype)
        hd = C // self.heads
        q = self.q_proj(x[:, :1]).view(B, 1, self.heads, hd).transpose(1, 2)
        k = self.k_proj(x).view(B, -1, self.heads, hd).transpose(1, 2)
        v = self.v_proj(x).view(B, -1, self.heads, hd).transpose(1, 2)
        s = torch.matmul(q, k.transpose(-1, -2)) / torch.tensor(float(hd) ** 0.5, dtype=x.dtype)
        p = torch.softmax(s.float(), dim=-1).to(x.dtype)
        out = torch.matmul(p, v).transpose(1, 2).reshape(B, 1, C)
        return self.c_proj(out)[:, 0]


class ResNetTower(nn.Module):
    """The ResNet-backboned image / audio tower (the JAX ``VisionTower``
    with ``backbone="resnet"``): stem, four stages, attention pool to
    ``embed_dim``. The grid is the input's size over 32 (7 x 7 at 224^2,
    31 x 4 over 1000 x 128); ``misc_stored_grid`` is the grid the pool's
    positional embedding is stored at."""

    backbone = "resnet"

    def __init__(self, width: int, embed_dim: int, resolution, heads: int, layers: Sequence[int],
                 in_channels: int = 3, misc_stored_grid: Optional[Tuple[int, int]] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.resolution, self.grid = resolution, resnet_grid(resolution)
        self.pre_encoder = ResNetPreEncoder(width, in_channels, dtype=dtype, device=device)
        self.pre_encoder_addon = AddonEncoder()
        self.encoder = ResNetBackbone(layers, width, device=device)
        self.post_encoder_addon = AddonEncoder()
        self.post_encoder = ResNetPostEncoder(width * 32, embed_dim, heads,
                                              misc_stored_grid or self.grid, device=device)

    def forward(self, x: torch.Tensor, train: bool = False, normalized: bool = False,
                require_feature: bool = False) -> torch.Tensor:
        from .heads import normalize

        h = self.pre_encoder_addon(self.pre_encoder(x, train=train))
        h = self.post_encoder_addon(self.encoder(h, train=train))
        emb = self.post_encoder(h, train=train)
        if require_feature:
            raise NotImplementedError("require_feature is ViT-only")
        return normalize(emb) if normalized else emb
