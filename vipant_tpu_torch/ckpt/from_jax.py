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

A loss head's leaves map by their last component (:func:`loss_state_dict`):
``logit_scale`` keeps its name, a dense ``kernel`` [in, out] becomes
``weight`` [out, in], a LayerNorm ``scale`` becomes ``weight``, a ``bias``
stays; the modules on the way keep the JAX names (``ln``, ``linear``,
``mlp/dense_0``, ``a2v/ln_0``, ``bce/mlp/...``, ``ce/logit_scale``), as the
port's classifier heads name them.

Elsewhere the mapping goes leaf by leaf, so a partial tree converts too: the
trainable subtree of a train state, its grads or its optimizer moments
(same shapes as the params), or a bool mask (``convert=False`` keeps the
leaves as they are and only renames them).

:func:`to_jax_params` goes the other way for the towers and loss heads:
the port's checkpoints write their ``model.npz`` under the JAX package's
names and layouts, so the JAX engine and the port's both serve it.

The ResNet towers (``pre/conv{i}``, ``pre/bn{i}``, ``encoder/layer{s}_{b}/...``,
``post/{q,k,v,c}_proj``, ``post/positional_embedding``) keep the JAX module
names below the stages ``pre_encoder``, ``encoder``, ``post_encoder``: HWIO
convolution kernels become OIHW ``weight``, dense kernels [in, out] torch
``weight`` [out, in], BatchNorm ``scale`` ``weight``. The DeiT towers
(``patch_kernel``, ``patch_bias``, ``cls_token``, ``dist_token``,
``pos_embed``, ``blocks/block_{i}``, ``norm``, ``head``, ``head_dist``) map
to ``patch_embed.weight`` (OIHW), ``patch_embed.bias``, the same names,
``blocks.resblocks.{i}`` (the trunk's leaves as above: the qkv kernel
[C, 3, C] becomes ``attn.in_proj_weight`` [3C, C]) and ``norm.weight``.

The JAX ``batch_stats`` collection (Barlow's and the ResNet towers'
BatchNorm running ``mean`` and ``var``) maps to the port's buffers of the
same dotted names, a tower's ``pre`` stage named ``pre_encoder``
(:func:`batch_stats_state_dict`, :func:`to_jax_batch_stats`).

Siamese ties: the JAX trainer prunes each tie's destination from its tree
(``prune_tied``) and restores it from the source for every apply. The port's
tied model holds one tensor under both names. :func:`load_params` takes a
pruned tree (the destinations come with their sources) or a full one (a
destination's own leaves are skipped: the source wins, as ``apply_ties``
has it); :func:`jax_params_of` gives a model's full or pruned tree.

Re-written here because ``vipant_tpu.ckpt`` imports JAX.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..nn.tying import tied_names

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
# the ResNet and DeiT towers, outside the DeiT trunk: (JAX path, port name, layout change)
_BACKBONE_LEAVES = [
    (r"pre/(conv\d)/kernel", r"pre_encoder.\1.weight", _oihw),
    (r"pre/(bn\d)/scale", r"pre_encoder.\1.weight", None),
    (r"pre/(bn\d)/bias", r"pre_encoder.\1.bias", None),
    (r"encoder/(layer\d_\d+)/(conv\d|downsample_conv)/kernel", r"encoder.\1.\2.weight", _oihw),
    (r"encoder/(layer\d_\d+)/(bn\d|downsample_bn)/scale", r"encoder.\1.\2.weight", None),
    (r"encoder/(layer\d_\d+)/(bn\d|downsample_bn)/bias", r"encoder.\1.\2.bias", None),
    (r"post/positional_embedding", "post_encoder.positional_embedding", None),
    (r"post/([qkvc]_proj)/kernel", r"post_encoder.\1.weight", _t),
    (r"post/([qkvc]_proj)/bias", r"post_encoder.\1.bias", None),
    (r"patch_kernel", "patch_embed.weight", _oihw),
    (r"patch_bias", "patch_embed.bias", None),
    (r"(cls_token|dist_token|pos_embed|head|head_dist)", r"\1", None),
    (r"norm/scale", "norm.weight", None),
    (r"norm/bias", "norm.bias", None),
]
# the same read backwards: (port name, JAX path, layout change)
_PORT_BACKBONE = [
    (r"pre_encoder\.(conv\d)\.weight", r"pre/\1/kernel", _oihw),
    (r"pre_encoder\.(bn\d)\.weight", r"pre/\1/scale", None),
    (r"pre_encoder\.(bn\d)\.bias", r"pre/\1/bias", None),
    (r"encoder\.(layer\d_\d+)\.(conv\d|downsample_conv)\.weight", r"encoder/\1/\2/kernel", _oihw),
    (r"encoder\.(layer\d_\d+)\.(bn\d|downsample_bn)\.weight", r"encoder/\1/\2/scale", None),
    (r"encoder\.(layer\d_\d+)\.(bn\d|downsample_bn)\.bias", r"encoder/\1/\2/bias", None),
    (r"post_encoder\.positional_embedding", "post/positional_embedding", None),
    (r"post_encoder\.([qkvc]_proj)\.weight", r"post/\1/kernel", _t),
    (r"post_encoder\.([qkvc]_proj)\.bias", r"post/\1/bias", None),
    (r"patch_embed\.weight", "patch_kernel", _oihw),
    (r"patch_embed\.bias", "patch_bias", None),
    (r"(cls_token|dist_token|pos_embed|head|head_dist)", r"\1", None),
    (r"norm\.weight", "norm/scale", None),
    (r"norm\.bias", "norm/bias", None),
]
_DEIT_BLOCK = re.compile(r"blocks/block_(\d+)/(.+)")
_PORT_DEIT_BLOCK = re.compile(r"blocks\.resblocks\.(\d+)\.(.+)")
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
    m = _DEIT_BLOCK.fullmatch(path)
    if m is not None:
        name, fn = _BLOCK_LEAVES[m.group(2)]
        return f"blocks.resblocks.{int(m.group(1))}.{name}", fn
    for pat, repl, fn in _BACKBONE_LEAVES:
        if re.fullmatch(pat, path):
            return re.sub(pat, repl, path), fn
    if path.startswith("encoder/transformer/blocks/"):
        raise NotImplementedError("pipeline-stacked trunks are not supported; unstack first "
                                  "(ROADMAP.md queue A, A15)")
    if path not in _TOWER_LEAVES:
        raise KeyError(f"JAX parameter {path!r} has no counterpart in the port")
    return _TOWER_LEAVES[path]


def tower_state_dict(params: Tree, convert: bool = True) -> Dict[str, Any]:
    """One ViT, ResNet or DeiT image / audio tower tree, or a
    ``TextTower``'s -> its port names."""
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


def loss_state_dict(params: Tree, convert: bool = True) -> Dict[str, Any]:
    """A loss head's tree -> its port names (see the module docstring)."""
    out = {}
    for path, leaf in _flat(params):
        *mods, last = path.split("/")
        if last not in ("logit_scale", "kernel", "scale", "bias"):
            raise KeyError(f"JAX loss parameter {path!r} has no counterpart in the port")
        name = ".".join([*mods, "weight" if last in ("kernel", "scale") else last])
        if convert:
            leaf = _a(leaf).T if last == "kernel" else _a(leaf)
        out[name] = leaf
    return out


def model_state_dict(params: Tree, convert: bool = True) -> Dict[str, Any]:
    """Whole-model tree {"image"|"image_v"|"audio"|"text"|"decoder"|"loss"|"lm_loss":
    subtree}, or any part of one -> the port model's names, prefixed with
    the tower name."""
    out: Dict[str, Any] = {}
    for tower, sub in params.items():
        if not sub:
            continue
        if tower in ("loss", "lm_loss"):
            conv = loss_state_dict(sub, convert)
        elif tower in ("image", "image_v", "audio", "text"):
            conv = tower_state_dict(sub, convert)
        elif tower == "decoder":
            conv = decoder_state_dict(sub, convert)
        else:
            raise KeyError(f"unknown tower {tower!r} in the JAX params")
        out.update({f"{tower}.{k}": v for k, v in conv.items()})
    return out


def to_jax_params(state_dict: Mapping[str, Any], resnet_towers: Iterable[str] = ()) -> Dict[str, Any]:
    """The inverse of :func:`model_state_dict` for the towers and the loss
    heads: the port's names (``audio.encoder.resblocks.0...``) and layouts
    -> the JAX package's nested params, as numpy arrays. This is what a
    checkpoint's ``model.npz`` holds, flattened with dots. A ResNet tower's
    stem ``pre_encoder.conv1`` has the port name of a ViT's patch kernel:
    ``resnet_towers`` names the towers whose backbone is a ResNet."""
    out: Dict[str, Any] = {}
    resnet = set(resnet_towers)
    for key, value in state_dict.items():
        tower, name = key.split(".", 1)
        a = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        if tower in ("loss", "lm_loss"):
            *mods, last = name.split(".")
            fn = _t if last == "weight" and a.ndim == 2 else None
            if last == "weight":
                last = "kernel" if a.ndim == 2 else "scale"
            elif last not in ("logit_scale", "bias"):
                raise KeyError(f"the port's parameter {key!r} has no JAX name")
            path = "/".join([*mods, last])
        elif tower in ("image", "image_v", "audio", "text"):
            m = _PORT_BLOCK_NAME.fullmatch(name) or _PORT_DEIT_BLOCK.fullmatch(name)
            rule = next((r for r in _PORT_BACKBONE if re.fullmatch(r[0], name)), None)
            if m is not None and m.group(2) in _PORT_BLOCK:
                leaf, fn = _PORT_BLOCK[m.group(2)]
                trunk = "encoder/transformer" if name.startswith("encoder.") else "blocks"
                path = f"{trunk}/block_{int(m.group(1))}/{leaf}"
            elif name in _PORT_TOWER and tower not in resnet:
                path, fn = _PORT_TOWER[name]
            elif rule is not None:
                path, fn = re.sub(rule[0], rule[1], name), rule[2]
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


_TOWER_STAGE = re.compile(r"(image|image_v|audio)\.(pre|post)\.")
_PORT_TOWER_STAGE = re.compile(r"(image|image_v|audio)\.(pre|post)_encoder\.")


def batch_stats_state_dict(stats: Tree) -> Dict[str, np.ndarray]:
    """The JAX ``batch_stats`` collection -> the port's buffer names (the
    same path, dotted, a tower's ``pre`` stage as ``pre_encoder``; no
    layout changes)."""
    return {_TOWER_STAGE.sub(r"\1.\2_encoder.", k.replace("/", ".")): _a(v)
            for k, v in _flat(stats)}


def to_jax_batch_stats(buffers: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`batch_stats_state_dict`: buffer name -> tensor
    to the nested ``batch_stats`` collection of numpy arrays."""
    return unflatten({_PORT_TOWER_STAGE.sub(r"\1.\2.", k):
                      v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                      for k, v in buffers.items()})


def load_batch_stats(model: torch.nn.Module, stats: Tree) -> None:
    """Copy a JAX ``batch_stats`` collection into ``model``'s buffers; every
    buffer must be there, with its shape."""
    sd = batch_stats_state_dict(stats)
    own = dict(model.named_buffers())
    if set(sd) != set(own):
        raise ValueError(f"batch_stats and the model's buffers differ on {sorted(set(sd) ^ set(own))}")
    with torch.no_grad():
        for k, v in sd.items():
            if tuple(own[k].shape) != v.shape:
                raise ValueError(f"{k}: model has shape {tuple(own[k].shape)}, batch_stats {v.shape}")
            own[k].copy_(torch.as_tensor(v))


def jax_params_of(model: torch.nn.Module, pruned: bool = False) -> Dict[str, Any]:
    """``model``'s parameters as the JAX package's tree: every tower whole
    (``pruned=False``, what ``restore_tied`` gives), or without the tied
    destinations (``pruned=True``, the JAX trainer's state)."""
    named = model.named_parameters(remove_duplicate=pruned)
    return to_jax_params({k: p for k, p in named}, resnet_towers(model))


def resnet_towers(model: torch.nn.Module) -> List[str]:
    """The names of ``model``'s towers with a ResNet backbone."""
    return [name for name, m in model.named_children() if getattr(m, "backbone", None) == "resnet"]


def load_params(model: torch.nn.Module, params: Tree) -> None:
    """Copy JAX params into ``model`` (towers absent from ``params`` are left
    as they are). Every key must exist in the model with the same shape. A
    tied destination's leaves are skipped: its source's are loaded."""
    dst = tied_names(model)
    sd = {k: v for k, v in model_state_dict(params).items() if k not in dst}
    own = model.state_dict()
    for k, v in sd.items():
        if k not in own:
            raise ValueError(f"JAX parameter {k!r} has no counterpart in the model")
        if tuple(own[k].shape) != v.shape:
            raise ValueError(f"{k}: model has shape {tuple(own[k].shape)}, weights {v.shape}")
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=False)
