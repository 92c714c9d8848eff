"""Checkpoint application shared by the trainers and the inference engine.

Counterpart of ``vipant_tpu/ckpt/loading.py``. The init priority is the
reference's, explicit checkpoint > CLIP weights > random
(`reference/cvap/model/cvap.py:61-128`); the callers apply it
(``InferenceEngine._load``, ``Trainer.load_pretrained``). Weights are
copied into the model's own parameters, in place and on their device, so
a trainer loads before its optimizer takes the parameters.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

from ..utils import run_root
from .reference_port import (load_torch_file, port_reference_audio, port_reference_image,
                             port_reference_text, reference_loss_params,
                             split_reference_checkpoint)
from .zoo import _MODELS, resolve

TOWERS = ("image", "image_v", "audio", "text", "decoder")
_PATCH_KERNEL = "pre_encoder.conv1.weight"


def model_towers(model: nn.Module) -> List[str]:
    """The towers of ``model`` that hold parameters."""
    return [t for t in TOWERS if getattr(model, t, None) is not None
            and any(True for _ in getattr(model, t).parameters())]


def load_tower(tower: nn.Module, sd: Mapping[str, torch.Tensor], what: str) -> None:
    """Copy ``sd`` into ``tower``'s parameters, in place: the same names,
    the same shapes. The one exception is a 3-channel patch kernel (CLIP's)
    over a 1-channel tower's: the tower takes the 3-channel tensor as its
    parameter (a new ``Parameter``, so load before an optimizer holds the
    old one) and takes its channel mean at every forward, as the
    reference does."""
    own = dict(tower.named_parameters())
    if set(own) != set(sd):
        raise ValueError(f"{what}: the weights and the tower differ on {sorted(set(own) ^ set(sd))}")
    with torch.no_grad():
        for name, p in own.items():
            v = sd[name]
            if tuple(v.shape) == tuple(p.shape):
                p.copy_(v)
            elif (name == _PATCH_KERNEL and v.dim() == 4 and p.shape[1] == 1
                  and (v.shape[0], *v.shape[2:]) == (p.shape[0], *p.shape[2:])):
                tower.pre_encoder.conv1.weight = nn.Parameter(
                    v.to(p.device, p.dtype), requires_grad=p.requires_grad)
            else:
                raise ValueError(f"{what} {name}: the tower has shape {tuple(p.shape)}, the weights "
                                 f"{tuple(v.shape)}")


def copy_logit_scales(model: nn.Module, scale: torch.Tensor) -> None:
    """``scale`` into every ``logit_scale`` parameter of ``model`` (the
    contrastive and the LM loss heads)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] == "logit_scale":
                p.copy_(scale.reshape(p.shape))


def apply_reference_ckpt(model: nn.Module, path: str, echo=None) -> List[str]:
    """Load a reference-format ``.pth`` into ``model``, in place: each tower
    the tuple holds and the model has, and the loss head's ``logit_scale``
    (``vipant_tpu/ckpt/loading.py:22-47``). Returns the towers loaded."""
    ckpt_cfg, payload = load_torch_file(path)
    parts = split_reference_checkpoint(payload)
    porters = {"audio": lambda sd, t: port_reference_audio(sd, t, ckpt_cfg),
               "image": port_reference_image, "text": port_reference_text}
    have = model_towers(model)
    loaded = []
    for name, port in porters.items():
        if parts.get(name) and name in have:
            tower = getattr(model, name)
            load_tower(tower, port(parts[name], tower), f"{path} {name}")
            loaded.append(name)
    scale = reference_loss_params(parts.get("loss") or {}).get("logit_scale")
    loss = getattr(model, "loss", None)
    if scale is not None and getattr(loss, "logit_scale", None) is not None:
        with torch.no_grad():
            loss.logit_scale.copy_(scale.reshape(loss.logit_scale.shape))
    if echo is not None:
        echo.info(f"loaded reference checkpoint {path} ({sorted(parts)})")
    return loaded


def clip_weights_path(cfg) -> Optional[str]:
    """The CLIP weights ``running.clip_model_root`` / ``clip_model_name``
    name, or None (``vipant_tpu/ckpt/loading.py:50-84``): a zoo name
    resolves to its canonical file and is checked against the published
    sha256 (``running.clip_verify_sha``, default on); a missing zoo file or
    a mismatch (warned) falls through to ``{root}/{name}.pt`` or ``.pth``,
    so a user's own weights under a zoo name keep loading. The shipped
    root ``/tmp/clip`` moves under ``TMPDIR`` (:func:`..utils.run_root`)."""
    run = cfg.get("running")
    if run is None:
        return None
    root = run_root(run.get("clip_model_root", "") or "")
    name = str(run.get("clip_model_name", "") or "")
    if not name:
        return None
    if name in _MODELS:
        try:
            return resolve(name, root, verify=bool(run.get("clip_verify_sha", True)))
        except FileNotFoundError:
            pass
        except RuntimeError as e:
            warnings.warn(f"{e}; treating it as custom (non-zoo) weights and loading "
                          f"via the plain path convention")
    for ext in (".pt", ".pth"):
        p = os.path.join(root, name + ext)
        if os.path.exists(p):
            return p
    return None


def report_sources(echo, model: nn.Module, sources: Dict[str, str]) -> None:
    """Log where each tower's weights came from; a tower left at the seeded
    random init beside towers that loaded is logged as a warning."""
    towers = model_towers(model)
    line = "; ".join(f"{t}: {sources.get(t, 'seeded random init')}" for t in towers)
    random = [t for t in towers if t not in sources]
    if sources and random:
        echo.warning(f"tower(s) {random} stay at the seeded random init ({line})")
    else:
        echo.info(f"tower weights: {line}")
