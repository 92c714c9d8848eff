"""Model assembly: config -> ``nn.Module``, seeded random init, and the
trainable-parameter mask.

Counterpart of ``vipant_tpu/models/build.py:26-115`` and ``:205-250`` for
the CVAP and CLAP workers. Parameters are fp32 (``param_dtype``);
activations run in ``compute_dtype`` (bfloat16 in the default config).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..nn.heads import build_audio_head, build_image_head, build_text_head
from ..nn.losses import build_loss_head
from .tasks import CLAP, CVAP


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.get("compute_dtype", "float32") == "bfloat16" else torch.float32


def build_main_model(cfg, device=None) -> nn.Module:
    """cfg.worker -> model on ``device``, parameters not yet initialised
    (see :func:`init_weights`)."""
    m = cfg.model
    kw = dict(dtype=compute_dtype(cfg), device=device)
    if cfg.worker == "CVAP":
        return CVAP(
            image=build_image_head(m.image, **kw),
            audio=build_audio_head(m.audio, **kw),
            loss=build_loss_head(m.loss, device=device),
        )
    if cfg.worker == "CLAP":
        if m.text.name == "SeqGenerationHead":
            raise NotImplementedError("the CLAP captioning decoder is not ported yet")
        return CLAP(
            audio=build_audio_head(m.audio, **kw),
            text=build_text_head(m.text, **kw),
            loss=build_loss_head(m.loss, device=device),
        )
    raise NotImplementedError(f"worker {cfg.worker!r} is not ported yet (CVAP, CLAP)")


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init in the JAX package's scheme (CLIP's depth-scaled normals,
    lecun-normal patch kernel), drawn from ``generator``, which must live on
    the parameters' device."""
    with torch.no_grad():
        for module in model.modules():
            if hasattr(module, "init_weights"):
                module.init_weights(generator)
    return model


# excl_modules names (the reference's stage names, or the JAX package's
# aliases of them) -> the port's stage modules
_STAGES = {"pre": "pre_encoder", "post": "post_encoder", "pre_addon": "pre_encoder_addon",
           "post_addon": "post_encoder_addon"}


def tunable_mask(cfg, model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True if trainable: the JAX package's rule
    (``vipant_tpu/models/build.py:tunable_mask``). A tower whose config sets
    ``freeze`` is frozen, the stages listed in ``running.excl_modules``
    (``vmodules`` image, ``amodules`` audio, ``lmodules`` text) are frozen,
    and the loss head is always trainable. Siamese ties are not ported."""
    run = cfg.get("running", None)
    if run is not None and "siamese" in run and bool(run.siamese.get("alive", False)):
        raise NotImplementedError("siamese parameter ties are not ported yet")
    m = cfg.model
    frozen = {t: bool(m[t].freeze) for t in ("image", "audio", "text") if t in m and "freeze" in m[t]}
    excl = {}
    if run is not None and "excl_modules" in run:
        for key, tower in (("vmodules", "image"), ("amodules", "audio"), ("lmodules", "text")):
            excl[tower] = [_STAGES.get(n, n) for n in run.excl_modules.get(key, []) or []]
    mask = {}
    for name, _ in model.named_parameters():
        tower, stage = name.split(".")[:2]
        mask[name] = not frozen.get(tower, False) and stage not in excl.get(tower, [])
    return mask
