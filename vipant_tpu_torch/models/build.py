"""Model assembly: config -> ``nn.Module``, seeded random init, CLIP
weights, and the trainable-parameter mask.

Counterpart of ``vipant_tpu/models/build.py:26-115``, ``:205-250`` and
``:279-338`` for the CVAP and CLAP workers (CLAP with a text tower, or with
the captioning decoder). Parameters are fp32 (``param_dtype``);
activations run in ``compute_dtype`` (bfloat16 in the default config).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import torch
from torch import nn

from ..ckpt.clip_port import port_clip_text, port_clip_visual, split_clip_state_dict
from ..ckpt.loading import copy_logit_scales, load_tower
from ..nn.heads import build_audio_head, build_image_head, build_text_head
from ..nn.losses import build_loss_head
from ..nn.seqgen import SeqGenerationHead
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
            t = m.text
            decoder = SeqGenerationHead(
                width=int(t.width), layers=int(t.layers), heads=int(t.heads),
                ctx_len=int(t.ctx_len), vocab_size=int(t.vocab_size), embed_dim=int(t.embed_dim),
                mem_width=int(t.mem_width), max_len_dec=int(t.max_len_dec), bias=bool(t.bias), **kw)
            loss = None if m.loss.name == "LMLossHead" else build_loss_head(m.loss, device=device)
            return CLAP(audio=build_audio_head(m.audio, **kw), text=None, loss=loss,
                        decoder=decoder, lm_loss=build_loss_head(m.loss, device=device))
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


def port_model_from_clip(model: nn.Module, clip_sd: Mapping[str, Any]) -> List[str]:
    """Initialise ``model``'s towers from a CLIP state dict, in place
    (``vipant_tpu/models/build.py:279-338``; the reference's init,
    `reference/cvap/model/cvap.py:100-128`, `clap.py:80-157`): the image
    tower as it is, the audio tower from the visual tower with the square
    grid re-gridded bilinearly to the audio grid (no slice), the text tower
    with its positional embedding cut to its context, and CLIP's
    ``logit_scale`` into every loss head's. Returns the towers loaded."""
    visual_sd, text_sd = split_clip_state_dict(clip_sd)
    loaded = []
    for name in ("image", "audio"):
        tower = getattr(model, name, None)
        if tower is not None and hasattr(tower, "grid"):  # a ViT tower (not a DummyHead)
            load_tower(tower, port_clip_visual(visual_sd, tower, use_slice=name == "image"),
                       f"CLIP visual -> {name}")
            loaded.append(name)
    text = getattr(model, "text", None)
    if text is not None and hasattr(text, "ctx_len"):
        load_tower(text, port_clip_text(text_sd, text), "CLIP text -> text")
        loaded.append("text")
    if "logit_scale" in text_sd:
        copy_logit_scales(model, text_sd["logit_scale"])
    return loaded


# excl_modules names (the reference's stage names, or the JAX package's
# aliases of them) -> the port's stage modules
_STAGES = {"pre": "pre_encoder", "post": "post_encoder", "pre_addon": "pre_encoder_addon",
           "post_addon": "post_encoder_addon"}


def tunable_mask(cfg, model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True if trainable: the JAX package's rule
    (``vipant_tpu/models/build.py:tunable_mask``). A tower whose config sets
    ``freeze`` is frozen, the stages listed in ``running.excl_modules``
    (``vmodules`` image, ``amodules`` audio, ``lmodules`` text) are frozen,
    and the loss heads are always trainable. The rule keys on the top-level
    name: the captioning decoder's is ``decoder``, not ``text``, so
    ``model.text.freeze`` does not freeze it (nor does the JAX package).
    Siamese ties are not ported."""
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
