"""Checkpoint bridges of the port: JAX parameters and ``model.npz``
(:mod:`.from_jax`); CLIP ``.pt`` and reference ``.pth`` weights into the
towers (:mod:`.clip_port`, :mod:`.reference_port`, :mod:`.loading`, the
offline zoo :mod:`.zoo`); the towers out to a reference ``.pth``
(:mod:`.reference_export`)."""

from .clip_port import (port_audio_from_audio, port_clip_text, port_clip_visual,
                        split_clip_state_dict)
from .loading import apply_reference_ckpt, clip_weights_path, load_tower
from .reference_export import export_reference_pth
from .reference_port import (load_torch_file, port_reference_audio, port_reference_image,
                             port_reference_text, reference_loss_params,
                             split_reference_checkpoint)

__all__ = [
    "apply_reference_ckpt",
    "clip_weights_path",
    "export_reference_pth",
    "load_torch_file",
    "load_tower",
    "port_audio_from_audio",
    "port_clip_text",
    "port_clip_visual",
    "port_reference_audio",
    "port_reference_image",
    "port_reference_text",
    "reference_loss_params",
    "split_clip_state_dict",
    "split_reference_checkpoint",
]
