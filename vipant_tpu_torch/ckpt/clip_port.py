"""CLIP state dict -> the port's tower state dicts.

Counterpart of ``vipant_tpu/ckpt/clip_port.py``: the checkpoint bridge by
which CLIP's image-tower weights initialise the audio tower ("visual
knowledge transfer") and by which CLIP and reference checkpoints load. The
port's towers carry the reference's MetaHead names
(``misc.positional_embedding``, ``pre_encoder.conv1.weight``,
``encoder.resblocks.{i}...``, ``post_encoder.proj``) in torch layout, so a
CLIP tensor only changes its name here (the inverse of
``vipant_tpu/ckpt/reference_port.py``'s ``_METAHEAD_VISUAL`` /
``_METAHEAD_TEXT``). Two tensors of a ViT tower are re-gridded to the
tower's patch grid (:func:`..ops.interp.slice_or_interp_pos_grid`,
:func:`..ops.interp.interp_conv_kernel_spatial`); the text tower's
positional embedding is cut to its context. Every other tensor is the
file's, bitwise.

CLIP's 3-channel patch kernel stays 3-channel for a 1-channel audio tower:
the tower takes the channel mean at every forward
(``nn/stages.py:ViTPreEncoder``), as the reference does, so the optimizer
sees the 3-channel leaf (:func:`.loading.load_tower`; the JAX package's
1-channel tower refuses that kernel at its first apply, ROADMAP.md queue
C, C9). A CLIP ResNet's visual entries go into a :class:`..nn.resnet.ResNetTower`
(:func:`port_clip_resnet`): convolutions as they are (OIHW), each
BatchNorm's weight and bias and its running mean and variance (the tower's
``mean`` / ``var`` buffers), the attention pool's projections, and its
positional embedding re-gridded bilinearly to the tower's grid.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.interp import interp_conv_kernel_spatial, slice_or_interp_pos_grid

StateDict = Dict[str, torch.Tensor]

# CLIP's names -> the port's, outside the trunk blocks (whose names are CLIP's below "resblocks.")
_VISUAL = [
    (r"^positional_embedding$", "misc.positional_embedding"),
    (r"^class_embedding$", "misc.class_embedding"),
    (r"^conv1\.weight$", "pre_encoder.conv1.weight"),
    (r"^ln_pre\.(.+)$", r"pre_encoder.ln.\1"),
    (r"^transformer\.resblocks\.(.+)$", r"encoder.resblocks.\1"),
    (r"^ln_post\.(.+)$", r"post_encoder.ln.\1"),
    (r"^proj$", "post_encoder.proj"),
]
_TEXT = [
    (r"^positional_embedding$", "misc.positional_embedding"),
    (r"^token_embedding\.weight$", "pre_encoder.token_embedding.weight"),
    (r"^transformer\.resblocks\.(.+)$", r"encoder.resblocks.\1"),
    (r"^ln_final\.(.+)$", r"post_encoder.ln.\1"),
    (r"^text_projection$", "post_encoder.proj"),
]
_RESNET_KEYS = re.compile(r"^(layer\d\.|attnpool\.|bn1\.)")


def as_tensor(x: Any) -> torch.Tensor:
    """A state-dict value (tensor or array) as a CPU tensor, detached."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x))


def rename(sd: Mapping[str, Any], rules) -> StateDict:
    """The entries of ``sd`` that some rule matches, under the first
    matching rule's name; the rest are dropped."""
    out = {}
    for k, v in sd.items():
        for pat, repl in rules:
            if re.match(pat, k):
                out[re.sub(pat, repl, k)] = as_tensor(v)
                break
    return out


def split_clip_state_dict(sd: Mapping[str, Any]) -> Tuple[StateDict, StateDict]:
    """A whole CLIP state dict -> (visual entries without ``visual.``, text
    entries with ``logit_scale``), CPU tensors (parity:
    ``vipant_tpu/ckpt/clip_port.py:39-55``)."""
    visual, text = {}, {}
    for k, v in sd.items():
        if k.startswith("visual."):
            visual[k[len("visual."):]] = as_tensor(v)
        elif k.startswith(("transformer.", "token_embedding.", "ln_final.")) or k in (
                "positional_embedding", "text_projection", "logit_scale"):
            text[k] = as_tensor(v)
    return visual, text


def port_clip_visual(visual_sd: Mapping[str, Any], tower, use_slice: bool = True,
                     src_grid: Optional[Tuple[int, int]] = None) -> StateDict:
    """CLIP visual entries -> the state dict of ``tower`` (a ViT
    ``VisionTower``), its positional embedding re-gridded from ``src_grid``
    (square from the embedding's length when omitted: CLIP's) to the
    tower's grid and its patch kernel to the tower's patch. A
    ``ResNetTower`` takes CLIP's ResNet entries (:func:`port_clip_resnet`)."""
    resnet_sd = any(_RESNET_KEYS.match(k) for k in visual_sd)
    if getattr(tower, "backbone", None) == "resnet":
        if not resnet_sd:
            raise ValueError("a ResNet tower takes CLIP's ResNet weights; these are a ViT's")
        return port_clip_resnet(visual_sd, tower)
    if resnet_sd:
        raise ValueError("CLIP ResNet weights go into a ResNet tower (model.*.encoder.name="
                         "ResNetBackbone), not a ViT tower")
    sd = rename(visual_sd, _VISUAL)
    pos = sd["misc.positional_embedding"]
    if src_grid is None:
        s = int(round(np.sqrt(pos.shape[0] - 1)))
        src_grid = (s, s)
    sd["misc.positional_embedding"] = slice_or_interp_pos_grid(
        pos, src_grid, tower.grid, n_prefix=1, use_slice=use_slice)
    sd["pre_encoder.conv1.weight"] = interp_conv_kernel_spatial(
        sd["pre_encoder.conv1.weight"], tower.pre_encoder.patch_hw)
    return sd


def port_audio_from_audio(audio_sd: Mapping[str, torch.Tensor], old_grid: Tuple[int, int],
                          tower, use_slice: bool = True) -> StateDict:
    """An audio tower's state dict (the port's names) retargeted to
    ``tower``'s time x freq grid: the ``from_pretrained`` path that loads a
    10 s model for 18 s Clotho clips (parity:
    ``vipant_tpu/ckpt/clip_port.py:169-188``)."""
    sd = {k: as_tensor(v) for k, v in audio_sd.items()}
    sd["misc.positional_embedding"] = slice_or_interp_pos_grid(
        sd["misc.positional_embedding"], old_grid, tower.grid, n_prefix=1, use_slice=use_slice)
    sd["pre_encoder.conv1.weight"] = interp_conv_kernel_spatial(
        sd["pre_encoder.conv1.weight"], tower.pre_encoder.patch_hw)
    return sd


def port_clip_text(text_sd: Mapping[str, Any], tower) -> StateDict:
    """CLIP text entries -> the state dict of ``tower`` (a ``TextTower``),
    the positional embedding cut to its ``ctx_len``."""
    sd = rename(text_sd, _TEXT)
    sd["misc.positional_embedding"] = sd["misc.positional_embedding"][: tower.ctx_len]
    return sd


_BN = {"weight": "weight", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_RESNET = [
    (r"^(conv\d)\.weight$", r"pre_encoder.\1.weight"),
    (r"^(bn\d)\.(weight|bias|running_mean|running_var)$", r"pre_encoder.\1.\2"),
    (r"^layer(\d)\.(\d+)\.(conv\d)\.weight$", r"encoder.layer\1_\2.\3.weight"),
    (r"^layer(\d)\.(\d+)\.(bn\d)\.(weight|bias|running_mean|running_var)$",
     r"encoder.layer\1_\2.\3.\4"),
    (r"^layer(\d)\.(\d+)\.downsample\.0\.weight$", r"encoder.layer\1_\2.downsample_conv.weight"),
    (r"^layer(\d)\.(\d+)\.downsample\.1\.(weight|bias|running_mean|running_var)$",
     r"encoder.layer\1_\2.downsample_bn.\3"),
    (r"^attnpool\.positional_embedding$", "post_encoder.positional_embedding"),
    (r"^attnpool\.([qkvc]_proj)\.(weight|bias)$", r"post_encoder.\1.\2"),
]


def port_clip_resnet(visual_sd: Mapping[str, Any], tower) -> StateDict:
    """CLIP ModifiedResNet visual entries -> the state dict (parameters and
    BatchNorm buffers) of ``tower`` (``vipant_tpu/ckpt/clip_port.py:208-277``):
    every tensor the file's, bitwise, but the pool's positional embedding,
    re-gridded from CLIP's square grid to the tower's (bilinear, no slice).
    ``num_batches_tracked`` has no counterpart (flax's momentum is fixed)."""
    sd = {}
    for k, v in rename(visual_sd, _RESNET).items():
        stem, last = k.rsplit(".", 1)
        sd[f"{stem}.{_BN.get(last, last)}"] = v
    pos = sd["post_encoder.positional_embedding"]
    s = int(round(np.sqrt(pos.shape[0] - 1)))
    sd["post_encoder.positional_embedding"] = slice_or_interp_pos_grid(
        pos, (s, s), tower.post_encoder.stored_grid, n_prefix=1, use_slice=False)
    return sd
