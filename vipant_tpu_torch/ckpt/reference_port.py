"""Reference VIP-ANT ``.pth`` checkpoints -> the port's tower state dicts.

Counterpart of ``vipant_tpu/ckpt/reference_port.py``. The reference saves
``{"cfg", "model": tuple of state dicts}``: arity 2 is (audio, loss), arity 4
(image, audio, text, loss) (`reference/cvap/model/helper.py:10-30`). Tower
state dicts come in two namings, the MetaHead layout
(`reference/cvap/module/encoder/clip_head.py`), which is the port's own,
and the "naive" layout that nests a whole CLIP VisualTransformer under
``encoder.`` (`reference/cvap/module/encoder/audio_head.py:136-162`); plain
CLIP naming passes too. All three are normalised to CLIP's names and go
through :mod:`.clip_port` (the grid retarget).
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..nn.stages import vit_grid
from .clip_port import StateDict, as_tensor, port_clip_text, port_clip_visual, rename

# the reference's MetaHead names -> CLIP's (vipant_tpu/ckpt/reference_port.py:57-73)
_METAHEAD_VISUAL = [
    (r"^misc\.positional_embedding$", "positional_embedding"),
    (r"^misc\.class_embedding$", "class_embedding"),
    (r"^pre_encoder\.conv1\.weight$", "conv1.weight"),
    (r"^pre_encoder\.ln\.(.+)$", r"ln_pre.\1"),
    (r"^encoder\.resblocks\.(.+)$", r"transformer.resblocks.\1"),
    (r"^post_encoder\.ln\.(.+)$", r"ln_post.\1"),
    (r"^post_encoder\.proj$", "proj"),
]
_METAHEAD_TEXT = [
    (r"^misc\.positional_embedding$", "positional_embedding"),
    (r"^pre_encoder\.token_embedding\.weight$", "token_embedding.weight"),
    (r"^encoder\.resblocks\.(.+)$", r"transformer.resblocks.\1"),
    (r"^post_encoder\.ln\.(.+)$", r"ln_final.\1"),
    (r"^post_encoder\.proj$", "text_projection"),
]


def load_torch_file(path: str) -> Tuple[Any, Any]:
    """A ``.pth`` / ``.pt`` file -> ``(cfg or None, payload)``: a reference
    checkpoint's ``cfg`` and model tuple, or a state dict. A TorchScript
    archive (the published CLIP files) loads through ``torch.jit.load`` and
    gives its module's state dict. The file is unpickled in full, as the
    reference's own loader does: load only files you trust."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except (RuntimeError, pickle.UnpicklingError):  # an archive torch.load does not take
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    if isinstance(obj, dict) and "model" in obj:
        return obj.get("cfg"), obj["model"]
    if hasattr(obj, "state_dict"):  # a module: torch.load hands TorchScript archives to jit.load
        return None, obj.state_dict()
    return None, obj


def split_reference_checkpoint(model_payload) -> Dict[str, StateDict]:
    """The tuple by arity: 2 = (audio, loss), 4 = (image, audio, text,
    loss); an absent part is ``{}``."""
    parts = list(model_payload)
    if len(parts) == 2:
        keys = ["audio", "loss"]
    elif len(parts) == 4:
        keys = ["image", "audio", "text", "loss"]
    else:
        raise ValueError(f"unexpected checkpoint arity {len(parts)}")
    return {k: {kk: as_tensor(vv) for kk, vv in (sd or {}).items()} for k, sd in zip(keys, parts)}


def _normalize_visual_sd(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """MetaHead, naive (``encoder.``) or plain CLIP naming -> CLIP's."""
    if any(k.startswith("misc.") for k in sd):
        return rename(sd, _METAHEAD_VISUAL)
    if any(k.startswith("encoder.") for k in sd):
        return {re.sub(r"^encoder\.", "", k): v for k, v in sd.items()}
    return dict(sd)


def _cfg_audio_grid(ckpt_cfg) -> Optional[Tuple[int, int]]:
    """The stored audio grid from the checkpoint's ``cfg.model.audio``
    (``resolution``, ``patch_size``, ``stride`` at that level, as the JAX
    package reads them), or None when the snapshot does not give one."""
    try:
        a = ckpt_cfg["model"]["audio"] if isinstance(ckpt_cfg, dict) else ckpt_cfg.model.audio
        res = a["resolution"] if isinstance(a, dict) else a.resolution
        patch = a.get("patch_size", 32) if hasattr(a, "get") else 32
        stride = a.get("stride", None) if hasattr(a, "get") else None
        return vit_grid(tuple(res) if isinstance(res, (list, tuple)) else res, patch, stride)[0]
    except (AttributeError, IndexError, KeyError, TypeError, ValueError):
        # e.g. an unresolved snapshot ("${running.max_audio_len}"), as the port and the JAX
        # package write it
        return None


def port_reference_audio(audio_sd: Mapping[str, torch.Tensor], tower, ckpt_cfg=None,
                         use_slice: bool = True) -> StateDict:
    """The audio tower of a reference checkpoint -> ``tower``'s state dict.
    The stored grid comes from the checkpoint's own config when it gives
    one (a rectangular grid cannot be told from the embedding's length),
    else it is taken to share the tower's frequency columns."""
    sd = _normalize_visual_sd(audio_sd)
    src_grid = None if ckpt_cfg is None else _cfg_audio_grid(ckpt_cfg)
    if src_grid is None:
        n_pos = sd["positional_embedding"].shape[0] - 1
        ncol = tower.grid[1]
        if n_pos % ncol == 0:
            src_grid = (n_pos // ncol, ncol)
    return port_clip_visual(sd, tower, use_slice=use_slice, src_grid=src_grid)


def port_reference_text(text_sd: Mapping[str, torch.Tensor], tower) -> StateDict:
    sd = rename(text_sd, _METAHEAD_TEXT) if any(k.startswith("misc.") for k in text_sd) else text_sd
    return port_clip_text(sd, tower)


def port_reference_image(image_sd: Mapping[str, torch.Tensor], tower) -> StateDict:
    return port_clip_visual(_normalize_visual_sd(image_sd), tower)


def reference_loss_params(loss_sd: Mapping[str, torch.Tensor]) -> StateDict:
    """What transfers from a reference loss head: ``logit_scale``, fp32."""
    if "logit_scale" in loss_sd:
        return {"logit_scale": as_tensor(loss_sd["logit_scale"]).float()}
    return {}
