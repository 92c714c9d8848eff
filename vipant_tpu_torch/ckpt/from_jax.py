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

The captioning decoder (``decoder/...``, a ``SeqGenerationHead``) and its
loss (``lm_loss/logit_scale``) have no counterpart in the reference exporter,
so their names are the port's own (:mod:`..nn.seqgen`): the decoder's trunk
blocks map like a tower's, under ``transformer.resblocks.{i}``, with
``ln_c`` and the cross-attention beside them. The cross-attention's separate
``q``, ``k``, ``v`` dense layers keep separate weights, in torch
``nn.MultiheadAttention``'s names for that case (kernels [C, C], [in, out]
-> ``cross_attn.{q,k,v}_proj_weight`` [out, in]), so each stays one leaf for
the optimizer (LARS scales every weight leaf by its own trust ratio); their
three biases are stacked into ``cross_attn.in_proj_bias`` [3C], q first: the
one place where three JAX leaves make one tensor of the port, so all three
must be present (a bool mask must agree on the three).
``predictor/kernel`` [width, vocab] -> ``predictor.weight``
[vocab, width].

Elsewhere the mapping goes leaf by leaf, so a partial tree converts too: the
trainable subtree of a train state, its grads or its optimizer moments
(same shapes as the params), or a bool mask (``convert=False`` keeps the
leaves as they are and only renames them).

:func:`to_jax_params` goes the other way for the towers and loss heads:
the port's checkpoints write their ``model.npz`` under the JAX package's
names and layouts, so the JAX engine and the port's both serve it.

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


def _qkv_kernel(a: np.ndarray) -> np.ndarray:  # [C, 3, C] -> [3C, C]
    return a.reshape(a.shape[0], -1).T


def _qkv_bias(a: np.ndarray) -> np.ndarray:  # [3, C] -> [3C]
    return a.reshape(-1)


def _oihw(a: np.ndarray) -> np.ndarray:  # HWIO -> OIHW
    return np.transpose(a, (3, 2, 0, 1))


# each layout change -> its inverse (the port's layout back to the JAX one)
_INVERSE: Dict[Callable, Callable] = {
    _t: _t,
    _qkv_kernel: lambda a: a.T.reshape(a.shape[1], 3, -1),
    _qkv_bias: lambda a: a.reshape(3, -1),
    _oihw: lambda a: np.transpose(a, (2, 3, 1, 0)),
}


# leaf path inside a trunk block -> (port name, layout change)
_BLOCK_LEAVES: Dict[str, Tuple[str, Optional[Callable]]] = {
    "attn/qkv/kernel": ("attn.in_proj_weight", _qkv_kernel),
    "attn/qkv/bias": ("attn.in_proj_bias", _qkv_bias),
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
    "pre/kernel": ("pre_encoder.conv1.weight", _oihw),
    "pre/ln/scale": ("pre_encoder.ln.weight", None),
    "pre/ln/bias": ("pre_encoder.ln.bias", None),
    "pre/token_embedding": ("pre_encoder.token_embedding.weight", None),
    "post/ln/scale": ("post_encoder.ln.weight", None),
    "post/ln/bias": ("post_encoder.ln.bias", None),
    "post/proj": ("post_encoder.proj", None),
}
# the tower tables read backwards, before the decoder's leaves join _BLOCK_LEAVES
_PORT_BLOCK = {name: (path, fn) for path, (name, fn) in _BLOCK_LEAVES.items()}
_PORT_TOWER = {name: (path, fn) for path, (name, fn) in _TOWER_LEAVES.items()}
_BLOCK_LEAVES.update({
    "ln_c/scale": ("ln_c.weight", None),
    "ln_c/bias": ("ln_c.bias", None),
    "cross_attn/out/kernel": ("cross_attn.out_proj.weight", _t),
    "cross_attn/out/bias": ("cross_attn.out_proj.bias", None),
})
# leaf path inside the captioning decoder, outside its trunk
_DECODER_LEAVES: Dict[str, Tuple[str, Optional[Callable]]] = {
    "token_embedding": ("token_embedding", None),
    "positional_embedding": ("positional_embedding", None),
    "to_txt": ("to_txt", None),
    "text_proj": ("text_proj", None),
    "mem_ln/scale": ("mem_ln.weight", None),
    "mem_ln/bias": ("mem_ln.bias", None),
    "ln_final/scale": ("ln_final.weight", None),
    "ln_final/bias": ("ln_final.bias", None),
    "predictor/kernel": ("predictor.weight", _t),
    "predictor/bias": ("predictor.bias", None),
}
_BLOCK = re.compile(r"encoder/transformer/block_(\d+)/(.+)")
_DECODER_BLOCK = re.compile(r"transformer/block_(\d+)/(.+)")
_CROSS_QKV = re.compile(r"cross_attn/([qkv])/(kernel|bias)")
_PORT_BLOCK_NAME = re.compile(r"encoder\.resblocks\.(\d+)\.(.+)")


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


def decoder_state_dict(params: Tree, convert: bool = True) -> Dict[str, Any]:
    """A ``SeqGenerationHead`` tree -> its port names (see the module
    docstring for the packing of the cross-attention)."""
    out: Dict[str, Any] = {}
    packed: Dict[str, Dict[str, Any]] = {}  # packed bias name -> {"q" | "k" | "v": leaf}
    for path, leaf in _flat(params):
        m = _DECODER_BLOCK.fullmatch(path)
        if m is None:
            if path not in _DECODER_LEAVES:
                raise KeyError(f"JAX parameter decoder/{path} has no counterpart in the port")
            name, fn = _DECODER_LEAVES[path]
        else:
            prefix = f"transformer.resblocks.{int(m.group(1))}."
            qkv = _CROSS_QKV.fullmatch(m.group(2))
            if qkv is not None and qkv.group(2) == "bias":
                packed.setdefault(f"{prefix}cross_attn.in_proj_bias", {})[qkv.group(1)] = (
                    _a(leaf) if convert else leaf)
                continue
            if qkv is not None:
                out[f"{prefix}cross_attn.{qkv.group(1)}_proj_weight"] = _a(leaf).T if convert else leaf
                continue
            name, fn = _BLOCK_LEAVES[m.group(2)]
            name = prefix + name
        if convert:
            leaf = _a(leaf) if fn is None else fn(_a(leaf))
        out[name] = leaf
    for name, parts in packed.items():
        if sorted(parts) != ["k", "q", "v"]:
            raise KeyError(f"{name} packs q, k and v: the tree holds only {sorted(parts)}")
        if convert:
            out[name] = np.concatenate([parts["q"], parts["k"], parts["v"]], axis=0)
        else:
            if not (parts["q"] == parts["k"] == parts["v"]):
                raise ValueError(f"{name}: q, k and v carry different leaves {parts}")
            out[name] = parts["q"]
    return out


def model_state_dict(params: Tree, convert: bool = True) -> Dict[str, Any]:
    """Whole-model tree {"image"|"audio"|"text"|"decoder"|"loss"|"lm_loss":
    subtree}, or any part of one -> the port model's names, prefixed with
    the tower name. A loss head's ``logit_scale`` (a scalar) is the only
    loss leaf the ported ``CELossHead`` and ``LMLossHead`` hold."""
    out: Dict[str, Any] = {}
    for tower, sub in params.items():
        if not sub:
            continue
        if tower in ("loss", "lm_loss"):
            conv = {k: _a(v) if convert else v for k, v in sub.items() if k == "logit_scale"}
        elif tower in ("image", "audio", "text"):
            conv = tower_state_dict(sub, convert)
        elif tower == "decoder":
            conv = decoder_state_dict(sub, convert)
        else:
            raise KeyError(f"unknown tower {tower!r} in the JAX params")
        out.update({f"{tower}.{k}": v for k, v in conv.items()})
    return out


def to_jax_params(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`model_state_dict` for the ViT and text towers
    and the loss heads: the port's names (``audio.encoder.resblocks.0...``)
    and layouts -> the JAX package's nested params, as numpy arrays. This is
    what a checkpoint's ``model.npz`` holds, flattened with dots."""
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        tower, name = key.split(".", 1)
        a = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        if tower in ("loss", "lm_loss") and name == "logit_scale":
            path, fn = name, None
        elif tower in ("image", "audio", "text"):
            m = _PORT_BLOCK_NAME.fullmatch(name)
            if m is not None and m.group(2) in _PORT_BLOCK:
                leaf, fn = _PORT_BLOCK[m.group(2)]
                path = f"encoder/transformer/block_{int(m.group(1))}/{leaf}"
            elif name in _PORT_TOWER:
                path, fn = _PORT_TOWER[name]
            else:
                raise KeyError(f"the port's parameter {key!r} has no JAX name")
        else:
            raise KeyError(f"the port's parameter {key!r} has no JAX name (towers and loss heads only)")
        node = out.setdefault(tower, {})
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a if fn is None else np.ascontiguousarray(_INVERSE[fn](a))
    return out


def flatten(tree: Tree) -> Dict[str, Any]:
    """Nested dict -> flat dotted keys (the layout of ``model.npz``); the
    inverse of :func:`unflatten`."""
    return {k.replace("/", "."): v for k, v in _flat(tree)}


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
