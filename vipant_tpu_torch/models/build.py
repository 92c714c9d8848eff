"""Model assembly: config -> ``nn.Module``, seeded random init, CLIP
weights, and the trainable-parameter mask.

Counterpart of ``vipant_tpu/models/build.py:26-115``, ``:205-270`` and
``:279-338`` for the CVAP and CLAP workers (CLAP with a text tower, or with
the captioning decoder), the classifiers ``ASClassifier`` and
``ESClassifier`` (their heads sized by ``output_dim``, the label count the
monitor reads from its dataset), the trimodal ``CVALP``, the siamese
``CVASP`` and the image-text ``CLVP``; and the siamese ties
(:func:`siamese_ties`, made by :func:`..nn.tying.tie_parameters`).
Parameters are fp32 (``param_dtype``); activations run in ``compute_dtype``
(bfloat16 in the default config).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch
from torch import nn

from ..ckpt.clip_port import port_clip_text, port_clip_visual, split_clip_state_dict
from ..ckpt.loading import copy_logit_scales, load_tower
from ..nn.heads import build_audio_head, build_image_head, build_text_head
from ..nn.losses import build_loss_head
from ..nn.seqgen import SeqGenerationHead
from ..nn.tying import tie_parameters
from .tasks import ASClassifier, CLAP, CLVP, CVALP, CVAP, CVASP, ESClassifier


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.get("compute_dtype", "float32") == "bfloat16" else torch.float32


def build_main_model(cfg, device=None, output_dim=None) -> nn.Module:
    """cfg.worker -> model on ``device``, parameters not yet initialised
    (see :func:`init_weights`). ``output_dim``: the classifiers' label
    count; a classifier head without it raises."""
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
    if cfg.worker in ("ASClassifier", "ESClassifier"):
        # the heads read the audio tower's raw embedding
        loss = build_loss_head(m.loss, device=device, in_dim=int(m.audio.embed_dim),
                               num_labels=output_dim)
        text = build_text_head(m.text, **kw) if "text" in m else None
        if cfg.worker == "ESClassifier":
            return ESClassifier(audio=build_audio_head(m.audio, **kw), loss=loss, text=text)
        return ASClassifier(audio=build_audio_head(m.audio, **kw), loss=loss, text=text,
                            image=build_image_head(m.image, **kw) if "image" in m else None)
    if cfg.worker == "CVALP":
        return CVALP(image=build_image_head(m.image, **kw), audio=build_audio_head(m.audio, **kw),
                     text=build_text_head(m.text, **kw), loss=build_loss_head(m.loss, device=device))
    if cfg.worker == "CVASP":
        return CVASP(image=build_image_head(m.image, **kw), image_v=build_image_head(m.image, **kw),
                     audio=build_audio_head(m.audio, **kw), loss=build_loss_head(m.loss, device=device))
    if cfg.worker == "CLVP":
        return CLVP(image=build_image_head(m.image, **kw), text=build_text_head(m.text, **kw),
                    loss=build_loss_head(m.loss, device=device))
    raise ValueError(f"unknown worker {cfg.worker!r} (CVAP, CLAP, CVALP, CVASP, ASClassifier, "
                     "ESClassifier, CLVP)")


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
    tower (and a siamese view tower) as it is, the audio tower from the
    visual tower with the square grid re-gridded bilinearly to the audio
    grid (no slice), the text tower
    with its positional embedding cut to its context, and CLIP's
    ``logit_scale`` into every loss head's. Returns the towers loaded."""
    visual_sd, text_sd = split_clip_state_dict(clip_sd)
    loaded = []
    for name in ("image", "image_v", "audio"):
        tower = getattr(model, name, None)
        if tower is not None and hasattr(tower, "grid"):  # a ViT tower (not a DummyHead)
            load_tower(tower, port_clip_visual(visual_sd, tower, use_slice=name != "audio"),
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


def siamese_ties(cfg) -> List[Tuple[str, str]]:
    """``running.siamese.{amodules,lmodules}`` -> ``(dst, src)`` ties: the
    audio / text tower's listed stages take the image tower's parameters
    (``vipant_tpu/models/build.py:253-270``; parity:
    `reference/cvap/model/cvalp.py:147-180`); ``CVASP`` also ties its view
    tower ``image_v`` whole to the pivot tower ``image``."""
    ties: List[Tuple[str, str]] = []
    if cfg.get("worker") == "CVASP":
        ties.append(("image_v", "image"))
    run = cfg.get("running", None)
    if run is None or "siamese" not in run or not bool(run.siamese.get("alive", False)):
        return ties
    for key, tower in (("amodules", "audio"), ("lmodules", "text")):
        for name in run.siamese.get(key, []) or []:
            stage = _STAGES.get(name, name)
            ties.append((f"{tower}/{stage}", f"image/{stage}"))
    return ties


def tie_model(cfg, model: nn.Module) -> List[Tuple[str, str]]:
    """Make :func:`siamese_ties`'s ties on ``model`` (after its weights are
    loaded: the destinations' own weights are dropped) and return them."""
    ties = siamese_ties(cfg)
    tie_parameters(model, ties)
    return ties


def tunable_mask(cfg, model: nn.Module, ties: Sequence[Tuple[str, str]] = ()) -> Dict[str, bool]:
    """Parameter name -> True if trainable: the JAX package's rule
    (``vipant_tpu/models/build.py:205-250``). A tower whose config sets
    ``freeze`` is frozen (``image_v`` follows ``model.image``), the stages
    listed in ``running.excl_modules`` (``vmodules`` image, ``amodules``
    audio, ``lmodules`` text) are frozen, and the loss heads are always
    trainable. The rule keys on the top-level name: the captioning decoder's
    is ``decoder``, not ``text``, so ``model.text.freeze`` does not freeze it
    (nor does the JAX package). A tied parameter is named once, under its
    source (``named_parameters()``), and is trainable when its source's
    tower or the tying tower is not frozen, whatever the rest says."""
    run = cfg.get("running", None)
    m = cfg.model
    frozen = {t: bool(m[t].freeze) for t in ("image", "audio", "text") if t in m and "freeze" in m[t]}
    if "image" in frozen:
        frozen["image_v"] = frozen["image"]
    excl = {}
    if run is not None and "excl_modules" in run:
        for key, tower in (("vmodules", "image"), ("amodules", "audio"), ("lmodules", "text")):
            excl[tower] = [_STAGES.get(n, n) for n in run.excl_modules.get(key, []) or []]
    mask = {}
    for name, _ in model.named_parameters():
        tower, stage = name.split(".")[:2]
        mask[name] = not frozen.get(tower, False) and stage not in excl.get(tower, [])
    for dst, src in ties:
        dst_tower, src_tower = dst.split("/")[0], src.split("/")[0]
        if not frozen.get(dst_tower, False) or not frozen.get(src_tower, False):
            prefix = src.replace("/", ".") + "."
            for name in mask:
                if name.startswith(prefix):
                    mask[name] = True
    return mask
