"""The port's towers -> reference VIP-ANT ``.pth`` checkpoints.

Counterpart of ``vipant_tpu/ckpt/reference_export.py:115-139``
(``export_reference_pth``): writes ``{"cfg", "model": tuple of state
dicts}``, arity 2 = (audio, loss) and 4 = (image, audio, text, loss)
(`reference/cvap/model/helper.py:10-30`), under the MetaHead names
(`reference/cvap/module/encoder/clip_head.py:126-292`), so the reference
codebase, the JAX package's loader and :mod:`.reference_port` all read it.
The port's towers already carry those names in torch layout, so a tower's
state dict is written as it is, in fp32; a loss head's leaves are written
flat (``logit_scale``), as ``export_loss_sd`` flattens them. The config
snapshot is a plain dict, unresolved.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from .clip_port import as_tensor

PARTS = ("image", "audio", "text", "loss")


def split_by_tower(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The model's names (``audio.encoder...``, ``loss.logit_scale``) ->
    ``{tower: its state dict}``."""
    parts: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in state_dict.items():
        tower, name = key.split(".", 1)
        parts.setdefault(tower, {})[name] = value
    return parts


def export_reference_pth(path: str, parts: Mapping[str, Mapping[str, Any]],
                         cfg: Optional[Any] = None) -> str:
    """Write a reference-format ``.pth``: a 2-tuple when ``parts`` holds
    only audio (and loss), a 4-tuple with ``{}`` for the absent or empty
    parts when it names image or text. Values are fp32 CPU tensors."""
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise KeyError(f"no reference checkpoint part for {sorted(unknown)} (only {PARTS})")
    order = PARTS if "image" in parts or "text" in parts else ("audio", "loss")
    model = tuple({k: as_tensor(v).to(torch.float32).clone() for k, v in (parts.get(p) or {}).items()}
                  for p in order)
    cfg_dict = None
    if cfg is not None:
        cfg_dict = cfg.to_dict(resolve=False) if hasattr(cfg, "to_dict") else dict(cfg)
    torch.save({"cfg": cfg_dict, "model": model}, path)
    return path
