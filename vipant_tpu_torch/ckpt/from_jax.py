"""Weight bridge: JAX package parameters -> the port's ``state_dict``.

Takes the JAX package's flax parameter tree (nested dicts of arrays, e.g.
``InferenceEngine.variables["params"]``) or its weight-only export
``model.npz`` (flat dotted keys, written beside every checkpoint) and
returns the port's state dict. The port's names are the reference
MetaHead / CLIP names that ``vipant_tpu/ckpt/reference_export.py`` emits;
the layouts change on the way:

- packed qkv kernel [C, 3, C] -> ``attn.in_proj_weight`` [3C, C], bias
  [3, C] -> [3C];
- dense kernels [in, out] -> torch Linear weights [out, in];
- the HWIO patch kernel -> OIHW ``pre_encoder.conv1.weight``;
- LayerNorm {scale, bias} -> {weight, bias}.

The mapping goes leaf by leaf, so a partial tree converts too: the
trainable subtree of a train state, its grads or its optimizer moments
(same shapes as the params), or a bool mask (``convert=False`` keeps the
leaves as they are and only renames them).

Re-written here because ``vipant_tpu.ckpt`` imports JAX.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

Tree = Mapping[str, Any]


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _t(a: np.ndarray) -> np.ndarray:
    return a.T


# leaf path inside a trunk block -> (port name, layout change)
_BLOCK_LEAVES: Dict[str, Tuple[str, Optional[Callable]]] = {
    "attn/qkv/kernel": ("attn.in_proj_weight", lambda a: a.reshape(a.shape[0], -1).T),
    "attn/qkv/bias": ("attn.in_proj_bias", lambda a: a.reshape(-1)),
    "attn/out/kernel": ("attn.out_proj.weight", _t),
    "attn/out/bias": ("attn.out_proj.bias", None),
    "ln_1/scale": ("ln_1.weight", None),
    "ln_1/bias": ("ln_1.bias", None),
    "ln_2/scale": ("ln_2.weight", None),
    "ln_2/bias": ("ln_2.bias", None),
    "mlp/fc/kernel": ("mlp.c_fc.weight", _t),
    "mlp/fc/bias": ("mlp.c_fc.bias", None),
    "mlp/proj/kernel": ("mlp.c_proj.weight", _t),
    "mlp/proj/bias": ("mlp.c_proj.bias", None),
}
# leaf path inside a ViT or text tower, outside the trunk
_TOWER_LEAVES: Dict[str, Tuple[str, Optional[Callable]]] = {
    "misc/positional_embedding": ("misc.positional_embedding", None),
    "misc/class_embedding": ("misc.class_embedding", None),
    "pre/kernel": ("pre_encoder.conv1.weight", lambda a: np.transpose(a, (3, 2, 0, 1))),
    "pre/ln/scale": ("pre_encoder.ln.weight", None),
    "pre/ln/bias": ("pre_encoder.ln.bias", None),
    "pre/token_embedding": ("pre_encoder.token_embedding.weight", None),
    "post/ln/scale": ("post_encoder.ln.weight", None),
    "post/ln/bias": ("post_encoder.ln.bias", None),
    "post/proj": ("post_encoder.proj", None),
}
_BLOCK = re.compile(r"encoder/transformer/block_(\d+)/(.+)")


def _flat(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def port_name(path: str) -> Tuple[str, Optional[Callable]]:
    """A '/'-joined leaf path inside a JAX tower -> (the port's parameter
    name inside the tower, the layout change or None)."""
    m = _BLOCK.fullmatch(path)
    if m is not None:
        name, fn = _BLOCK_LEAVES[m.group(2)]
        return f"encoder.resblocks.{int(m.group(1))}.{name}", fn
    if path.startswith("encoder/transformer/blocks/"):
        raise NotImplementedError("pipeline-stacked trunks are not supported; unstack first")
    if path not in _TOWER_LEAVES:
        raise KeyError(f"JAX parameter {path!r} has no counterpart in the port")
    return _TOWER_LEAVES[path]


def tower_state_dict(params: Tree, convert: bool = True) -> Dict[str, Any]:
    """One ViT (``VisionTower``) or ``TextTower`` tree -> its port names."""
    out = {}
    for path, leaf in _flat(params):
        name, fn = port_name(path)
        if convert:
            leaf = _a(leaf) if fn is None else fn(_a(leaf))
        out[name] = leaf
    return out


def model_state_dict(params: Tree, convert: bool = True) -> Dict[str, Any]:
    """Whole-model tree {"image"|"audio"|"text"|"loss": subtree}, or any part
    of one -> the port model's names, prefixed with the tower name. The
    loss head's ``logit_scale`` (a scalar) is the only loss leaf the ported
    ``CELossHead`` holds."""
    out: Dict[str, Any] = {}
    for tower, sub in params.items():
        if not sub:
            continue
        if tower == "loss":
            conv = {k: _a(v) if convert else v for k, v in sub.items() if k == "logit_scale"}
        elif tower in ("image", "audio", "text"):
            conv = tower_state_dict(sub, convert)
        else:
            raise KeyError(f"unknown tower {tower!r} in the JAX params")
        out.update({f"{tower}.{k}": v for k, v in conv.items()})
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat dotted keys (``model.npz``) -> nested dict."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node, parts = tree, key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def read_npz(path: str) -> Dict[str, Any]:
    """The JAX package's ``model.npz`` -> nested params dict."""
    with np.load(path) as data:
        return unflatten({k: data[k] for k in data.files})


def load_params(model: torch.nn.Module, params: Tree) -> None:
    """Copy JAX params into ``model`` (towers absent from ``params`` are left
    as they are). Every key must exist in the model with the same shape."""
    sd = model_state_dict(params)
    own = model.state_dict()
    for k, v in sd.items():
        if k not in own:
            raise ValueError(f"JAX parameter {k!r} has no counterpart in the model")
        if tuple(own[k].shape) != v.shape:
            raise ValueError(f"{k}: model has shape {tuple(own[k].shape)}, weights {v.shape}")
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=False)
