"""Encoder towers ("heads") composed from MetaHead stages, plus registries.

Counterpart of ``vipant_tpu/nn/heads.py`` for the ViT vision/audio tower
(with patchout in training), the ResNet tower (:mod:`.resnet`), the DeiT
tower (:mod:`.deit`) and the GPT text tower; ``require_feature`` also
returns a ViT audio tower's feature grid, the captioning decoder's memory.
``stacked`` (``model.*.stacked``, which the trainer sets for the ``pipe``
and ``seq`` axes) marks a tower's trunk for the pipeline or the ring
(:class:`.layers.Transformer`), in ``pipe_microbatches`` microbatches.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.quant import int8_fwd_context
from ..utils import Registry
from .deit import deit_from_cfg
from .layers import pack_tokens
from .resnet import ResNetTower
from .stages import (
    AddonEncoder,
    CLIPMisc,
    GPTPostEncoder,
    GPTPreEncoder,
    TransformerBackbone,
    ViTPostEncoder,
    ViTPreEncoder,
    vit_grid,
)

IMAGE_HEADS = Registry("IMAGE_HEADS")
AUDIO_HEADS = Registry("AUDIO_HEADS")
TEXT_HEADS = Registry("TEXT_HEADS")


def normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    # eps: an all-zero row (a zero-padded or missing embedding) must give
    # zeros, not 0/0 = NaN; real embeddings have norm >> eps
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-8)


def _pack(h: torch.Tensor, k: int):
    """Token packing when ``k`` divides the batch: ([B/k, kT, C], bias)."""
    if k > 1 and h.shape[0] % k == 0:
        return pack_tokens(h, k)
    return h, None


class VisionTower(nn.Module):
    """ViT image/audio tower. The audio tower is this module over the
    [1, T, M] log-mel "image" with a rectangular grid and overlapping stride.
    ``misc_stored_grid`` is the grid the positional embedding is stored at
    (another tower's, when tied); the forward re-grids to the tower's own.
    ``token_pack`` runs k items per attention call behind a block-diagonal
    mask (exact). ``int8_frozen`` runs the trunk on the forward-only int8
    sub-blocks: for a frozen tower only, whose output no gradient flows
    through; on a trainable tower the backward raises.

    ``patchout`` (PaSST, FLAP) drops that share of the patch tokens in a
    training forward: one subset for the whole batch, ``keep = max(int(n *
    (1 - patchout)), 1)`` of the n patches, sorted, the class token kept,
    after the positional embedding and before packing. The subset is drawn
    by :meth:`patchout_indices` from ``patchout_generator`` (the trainer
    sets it to its train state's generator, the stream SpecAugment draws
    from, so a resume replays it; else torch's default generator of the
    device); a test may replace the method to inject an index set."""

    backbone = "transformer"

    def __init__(self, width: int, embed_dim: int, resolution, heads: int, layers: int,
                 patch_size=32, stride=None, in_channels: int = 3,
                 misc_stored_grid: Optional[Tuple[int, int]] = None, token_pack: int = 1,
                 patchout: float = 0.0, int8_frozen: bool = False, stacked: bool = False,
                 pipe_microbatches: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.grid, patch_hw, stride_hw = vit_grid(resolution, patch_size, stride)
        self.token_pack, self.patchout = int(token_pack or 1), float(patchout)
        self.patchout_generator: Optional[torch.Generator] = None
        self.int8_frozen = bool(int8_frozen)
        self.misc = CLIPMisc(width, stored_grid=misc_stored_grid or self.grid,
                             target_grid=self.grid, device=device)
        self.pre_encoder = ViTPreEncoder(width, patch_hw, stride_hw, in_channels,
                                         dtype=dtype, device=device)
        self.pre_encoder_addon = AddonEncoder()
        self.encoder = TransformerBackbone(int(layers), width, heads, stacked=stacked,
                                           pipe_microbatches=pipe_microbatches, device=device)
        self.post_encoder_addon = AddonEncoder()
        self.post_encoder = ViTPostEncoder(width, embed_dim, device=device)

    def forward(self, x: torch.Tensor, train: bool = False, normalized: bool = False,
                require_feature: bool = False):
        if train and self.patchout > 0.0:
            if require_feature:
                raise ValueError(
                    "patchout is incompatible with require_feature (captioning decoder memory "
                    "needs the full patch grid): set model.audio.patchout=0 for captioning configs")
        pos, cls = self.misc()
        h = self.pre_encoder(x, pos, cls)
        if train and self.patchout > 0.0:
            n = h.shape[1] - 1
            keep = max(int(n * (1.0 - self.patchout)), 1)
            idx = self.patchout_indices(n, keep, h.device)
            idx = torch.cat([torch.zeros(1, dtype=idx.dtype, device=idx.device), idx])
            h = h.index_select(1, idx)
        h = self.pre_encoder_addon(h)
        B, T, C = h.shape
        h, attn_bias = _pack(h, self.token_pack)
        # not int8_frozen: an enclosing scope (an int8 engine) stays as it is
        with int8_fwd_context() if self.int8_frozen else contextlib.nullcontext():
            h = self.encoder(h, attn_bias=attn_bias).reshape(B, T, C)
        out = self.post_encoder(self.post_encoder_addon(h), require_feature=require_feature,
                                grid=self.grid)
        if require_feature:
            emb, feat = out
            return (normalize(emb) if normalized else emb), feat
        return normalize(out) if normalized else out


    def patchout_indices(self, n: int, keep: int, device) -> torch.Tensor:
        """``keep`` of the ``n`` patch tokens, sorted, as token positions
        (1 + patch index): the first ``keep`` of a permutation."""
        g = self.patchout_generator
        perm = torch.randperm(n, generator=g, device=g.device if g is not None else device)
        return torch.sort(perm[:keep])[0].to(device) + 1


class TextTower(nn.Module):
    """GPT-style causal text tower with EOT pooling; ``token_pack`` packs k
    captions per attention call (block-diagonal + causal = per-segment
    causal, exact)."""

    def __init__(self, width: int, embed_dim: int, vocab_size: int = 49408,
                 ctx_len: int = 77, heads: int = 8, layers: int = 12, token_pack: int = 1,
                 stacked: bool = False, pipe_microbatches: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.ctx_len, self.token_pack = ctx_len, int(token_pack or 1)
        self.misc = CLIPMisc(width, stored_grid=None, seq_len=ctx_len, device=device)
        self.pre_encoder = GPTPreEncoder(vocab_size, width, dtype=dtype, device=device)
        self.pre_encoder_addon = AddonEncoder()
        self.encoder = TransformerBackbone(layers, width, heads, use_attn_mask=True,
                                           stacked=stacked, pipe_microbatches=pipe_microbatches,
                                           device=device)
        self.post_encoder_addon = AddonEncoder()
        self.post_encoder = GPTPostEncoder(width, embed_dim, device=device)

    def forward(self, ids: torch.Tensor, train: bool = False, normalized: bool = False):
        pos, _ = self.misc()
        h, eot_idx = self.pre_encoder(ids, pos)
        h = self.pre_encoder_addon(h)
        B, T, C = h.shape
        h, attn_bias = _pack(h, self.token_pack)
        h = self.encoder(h, attn_bias=attn_bias).reshape(B, T, C)
        emb = self.post_encoder(self.post_encoder_addon(h), eot_idx)
        return normalize(emb) if normalized else emb


class DummyHead(nn.Module):
    """Disabled tower: passes its input through."""

    def forward(self, x, **kwargs):
        return x


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def _stacking(cfg) -> dict:
    mb = cfg.get("pipe_microbatches", None)
    return {"stacked": bool(cfg.get("stacked", False)),
            "pipe_microbatches": int(mb) if mb else None}


def _vision_from_cfg(cfg, dtype=torch.float32, device=None):
    resolution = cfg.resolution
    if isinstance(resolution, list):
        resolution = tuple(int(v) for v in resolution)
    pre = cfg.pre_encoder
    if cfg.encoder.name == "ResNetBackbone":
        # ViT-only knobs: ignoring them would train other semantics than configured
        for knob in ("patchout", "token_pack", "int8_frozen"):
            if cfg.get(knob, None) and (knob != "token_pack" or int(cfg.get(knob)) > 1):
                raise ValueError(f"{knob} is not supported on the resnet backbone")
        return ResNetTower(
            width=int(cfg.width), embed_dim=int(cfg.embed_dim), resolution=resolution,
            heads=int(cfg.get("heads", 12)), layers=[int(v) for v in cfg.encoder.layers],
            in_channels=int(pre.get("in_channels", 3)), dtype=dtype, device=device)
    return VisionTower(
        width=int(cfg.width),
        embed_dim=int(cfg.embed_dim),
        resolution=resolution,
        heads=int(cfg.get("heads", 12)),
        layers=int(cfg.encoder.layers),
        patch_size=pre.get("patch_size", 32),
        stride=pre.get("stride", None),
        in_channels=int(pre.get("in_channels", 3)),
        token_pack=int(cfg.get("token_pack", 1) or 1),
        patchout=float(cfg.get("patchout", 0.0) or 0.0),
        int8_frozen=bool(cfg.get("int8_frozen", False)),
        **_stacking(cfg),
        dtype=dtype,
        device=device,
    )


@IMAGE_HEADS.register(name="CLIPImageHead")
def build_clip_image_head(cfg, dtype=torch.float32, device=None):
    return _vision_from_cfg(cfg, dtype, device)


@AUDIO_HEADS.register(name="CLIPAudioHead")
def build_clip_audio_head(cfg, dtype=torch.float32, device=None):
    return _vision_from_cfg(cfg, dtype, device)


@TEXT_HEADS.register(name="CLIPTextHead")
def build_clip_text_head(cfg, dtype=torch.float32, device=None):
    return TextTower(
        width=int(cfg.width),
        embed_dim=int(cfg.embed_dim),
        vocab_size=int(cfg.pre_encoder.get("vocab_size", 49408)),
        ctx_len=int(cfg.get("ctx_len", 77)),
        heads=int(cfg.get("heads", 8)),
        layers=int(cfg.encoder.layers),
        token_pack=int(cfg.get("token_pack", 1) or 1),
        **_stacking(cfg),
        dtype=dtype,
        device=device,
    )


# legacy head names: the pre-MetaHead config groups (`model/image/vit.yaml`,
# `model/audio/vit.yaml`, `model/text/transformer.yaml`) name these; they
# build the same towers
IMAGE_HEADS.register(build_clip_image_head, name="ImageHead")
AUDIO_HEADS.register(build_clip_audio_head, name="NaiveCLIPAudioHead")
TEXT_HEADS.register(build_clip_text_head, name="TextHead")


IMAGE_HEADS.register(deit_from_cfg, name="DeiTImageHead")
AUDIO_HEADS.register(deit_from_cfg, name="NaiveDeiTAudioHead")


def _build_dummy(cfg, dtype=torch.float32, device=None):
    return DummyHead()


IMAGE_HEADS.register(_build_dummy, name="DummyHead")
AUDIO_HEADS.register(_build_dummy, name="DummyHead")
TEXT_HEADS.register(_build_dummy, name="DummyHead")


def build_image_head(cfg, **kw):
    return IMAGE_HEADS.get(cfg.name)(cfg, **kw)


def build_audio_head(cfg, **kw):
    return AUDIO_HEADS.get(cfg.name)(cfg, **kw)


def build_text_head(cfg, **kw):
    return TEXT_HEADS.get(cfg.name)(cfg, **kw)
