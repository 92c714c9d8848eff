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

Re-written here because ``vipant_tpu.ckpt`` imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Tree = Mapping[str, Any]


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _ln(tree: Tree, prefix: str) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": _a(tree["scale"]), f"{prefix}.bias": _a(tree["bias"])}


def _blocks(encoder: Tree) -> Dict[str, np.ndarray]:
    trunk = encoder["transformer"]
    if "blocks" in trunk:
        raise NotImplementedError("pipeline-stacked trunks are not supported; unstack first")
    out: Dict[str, np.ndarray] = {}
    for name in sorted(trunk, key=lambda n: int(n.split("_")[1])):
        blk, p = trunk[name], f"encoder.resblocks.{int(name.split('_')[1])}"
        qk = _a(blk["attn"]["qkv"]["kernel"])
        out[f"{p}.attn.in_proj_weight"] = qk.reshape(qk.shape[0], -1).T
        out[f"{p}.attn.in_proj_bias"] = _a(blk["attn"]["qkv"]["bias"]).reshape(-1)
        out[f"{p}.attn.out_proj.weight"] = _a(blk["attn"]["out"]["kernel"]).T
        out[f"{p}.attn.out_proj.bias"] = _a(blk["attn"]["out"]["bias"])
        out.update(_ln(blk["ln_1"], f"{p}.ln_1"))
        out.update(_ln(blk["ln_2"], f"{p}.ln_2"))
        out[f"{p}.mlp.c_fc.weight"] = _a(blk["mlp"]["fc"]["kernel"]).T
        out[f"{p}.mlp.c_fc.bias"] = _a(blk["mlp"]["fc"]["bias"])
        out[f"{p}.mlp.c_proj.weight"] = _a(blk["mlp"]["proj"]["kernel"]).T
        out[f"{p}.mlp.c_proj.bias"] = _a(blk["mlp"]["proj"]["bias"])
    return out


def visual_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """ViT ``VisionTower`` params -> tower state dict."""
    out = {
        "misc.positional_embedding": _a(params["misc"]["positional_embedding"]),
        "misc.class_embedding": _a(params["misc"]["class_embedding"]),
        "pre_encoder.conv1.weight": np.transpose(_a(params["pre"]["kernel"]), (3, 2, 0, 1)),
        "post_encoder.proj": _a(params["post"]["proj"]),
    }
    out.update(_ln(params["pre"]["ln"], "pre_encoder.ln"))
    out.update(_ln(params["post"]["ln"], "post_encoder.ln"))
    out.update(_blocks(params["encoder"]))
    return out


def text_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """``TextTower`` params -> tower state dict."""
    out = {
        "misc.positional_embedding": _a(params["misc"]["positional_embedding"]),
        "pre_encoder.token_embedding.weight": _a(params["pre"]["token_embedding"]),
        "post_encoder.proj": _a(params["post"]["proj"]),
    }
    out.update(_ln(params["post"]["ln"], "post_encoder.ln"))
    out.update(_blocks(params["encoder"]))
    return out


def loss_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """Loss-head params: ``logit_scale`` (a scalar) is the only one the
    ported ``CELossHead`` holds."""
    return {k: _a(v) for k, v in params.items() if k == "logit_scale"}


def model_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """Whole-model params {"image"|"audio"|"text"|"loss": subtree} -> the
    port model's state dict, keys prefixed with the tower name."""
    out: Dict[str, np.ndarray] = {}
    for tower, sub in params.items():
        if not sub:
            continue
        if tower == "loss":
            conv = loss_state_dict
        elif tower == "text":
            conv = text_state_dict
        elif tower in ("image", "audio"):
            conv = visual_state_dict
        else:
            raise KeyError(f"unknown tower {tower!r} in the JAX params")
        out.update({f"{tower}.{k}": v for k, v in conv(sub).items()})
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
