"""The port's checkpoint loading and export (vipant_tpu_torch/ckpt/:
``clip_port``, ``reference_port``, ``reference_export``, ``loading``,
``zoo``; ``models.port_model_from_clip``; ``ops/interp.py``) against the
JAX package's (vipant_tpu/ckpt/, ``vipant_tpu.models.port_model_from_clip``,
``vipant_tpu/ops/interp.py``) on the CPU, at 2 layers and width 64, on
state dicts built from a seed (tests/torch_oracle.py's CLIP, and reference
checkpoints in its MetaHead and naive layouts):

- every loaded tensor, leaf by leaf, equals the JAX porter's after
  ``ckpt/from_jax.py``'s mapping: bitwise, except the re-gridded position
  grids and patch kernels, which are held to 1e-5 (``F.interpolate`` and
  ``jax.image.resize`` agree to fp32 rounding: max |d| 1.1e-6 on 7x7 ->
  61x5, 6.8e-6 on a 32x32 -> 40x40 kernel);
- the reference ``.pth`` the port writes has the JAX export's keys, shapes
  and values, bitwise; a port model exported and read by the JAX loader
  gives the port's forward to max |d| 1e-4 in fp32 (2 layers, fp32 sums in
  other orders), and so does a JAX export read by the port;
- a TorchScript archive (the published CLIP files' format) loads, through
  ``torch.load``'s dispatch and through the ``torch.jit.load`` fallback;
- the zoo and ``clip_weights_path`` answer as the JAX package's on the same
  directories, with the ``_MODELS`` table equal to the original;
- a 1-channel audio tower keeps CLIP's 3-channel patch kernel as its
  parameter (the trainer's optimizer steps that leaf);
- the engine's and the trainer's init priority: ``.pth`` > step directory
  > CLIP (only without ``model_file`` in the trainer) > seeded random, the
  towers a ``model.npz`` leaves out from CLIP, and ``export_pth``.
"""

import hashlib
import logging
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipant_tpu.ckpt.zoo as jax_zoo
from vipant_tpu.ckpt import clip_port as jax_clip_port
from vipant_tpu.ckpt import reference_port as jax_reference_port
from vipant_tpu.ckpt.loading import apply_reference_ckpt as jax_apply_reference_ckpt
from vipant_tpu.ckpt.loading import clip_weights_path as jax_clip_weights_path
from vipant_tpu.ckpt.reference_export import export_reference_pth as jax_export_reference_pth
from vipant_tpu.ckpt.reference_export import export_visual_sd as jax_export_visual_sd
from vipant_tpu.config import Config as JaxConfig
from vipant_tpu.config import compose as jax_compose
from vipant_tpu.nn import TextTower as JaxTextTower
from vipant_tpu.nn import VisionTower as JaxVisionTower
from vipant_tpu.ops import interp as jax_interp
from vipant_tpu.serve import InferenceEngine as JaxEngine
from vipant_tpu.train import build_monitor as jax_build_monitor
from vipant_tpu_torch.ckpt import clip_port, from_jax, loading, reference_export, reference_port, zoo
from vipant_tpu_torch.config import Config, compose
from vipant_tpu_torch.models import build_main_model, init_weights, port_model_from_clip
from vipant_tpu_torch.nn.heads import TextTower, VisionTower
from vipant_tpu_torch.ops import interp
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer, build_monitor

from test_reference_port import _metahead_text_sd, _naive_audio_sd
from test_trainers import TINY_MODEL
from torch_oracle import TorchText, TorchVisual, clip_state_dict
from torch_dist_worker import one_rank

REGRID_TOL = 1e-5  # F.interpolate against jax.image.resize, fp32
FORWARD_TOL = 1e-4  # a 2-layer tower's fp32 output, one package against the other
W, EMB, HEADS, LAYERS, TEXT_W, CTX = 64, 32, 4, 2, 32, 16
# geometry name -> (resolution, patch, stride, in_channels)
GEOMETRY = {
    "image": (224, 32, None, 3),
    "audio": ((100, 128), 32, (16, 24), 3),  # grid 5 x 5
    "audio_10s": ((1000, 128), 32, (16, 24), 3),  # 61 x 5, the flagship's grid
    "audio_18s": ((1800, 128), 32, (16, 24), 3),  # 111 x 5
    "audio_5s": ((500, 128), 32, (16, 24), 3),  # 30 x 5
    "audio_p40": ((100, 128), 40, (16, 24), 3),  # 4 x 4, the kernel re-gridded 32 -> 40
    "audio_p16": ((100, 128), 16, (16, 24), 3),  # 6 x 5, the kernel re-gridded 32 -> 16
    "audio_1ch": ((100, 128), 32, (16, 24), 1),
}
POS, KERNEL = "misc.positional_embedding", "pre_encoder.conv1.weight"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def towers(name):
    """(JAX tower, port tower) of one geometry, or the text towers."""
    if name == "text":
        return (JaxTextTower(width=TEXT_W, embed_dim=EMB, heads=HEADS, layers=LAYERS, ctx_len=CTX),
                TextTower(width=TEXT_W, embed_dim=EMB, heads=HEADS, layers=LAYERS, ctx_len=CTX))
    res, patch, stride, ch = GEOMETRY[name]
    kw = dict(width=W, embed_dim=EMB, resolution=res, heads=HEADS, layers=LAYERS, patch_size=patch,
              stride=stride, in_channels=ch)
    return JaxVisionTower(**kw), VisionTower(**kw)


@pytest.fixture(scope="module")
def oracle():
    torch.manual_seed(0)
    visual = TorchVisual(width=W, layers=LAYERS, heads=HEADS, embed_dim=EMB)
    text = TorchText(width=TEXT_W, layers=LAYERS, heads=HEADS, embed_dim=EMB)
    return visual, text, clip_state_dict(visual, text)


@pytest.fixture(scope="module")
def clip_sd(oracle):
    return oracle[2]


def jax_tree_sd(tree):
    """A JAX porter's tower tree -> the port's names and layouts (numpy)."""
    return from_jax.tower_state_dict(tree.get("params", tree))


def assert_same(got, want, regridded=()):
    """``got`` (the port's torch tensors) against ``want`` (numpy, the port's
    names): bitwise, ``regridded`` names within REGRID_TOL."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].detach().cpu().numpy()
        assert g.shape == w.shape, k
        if k in regridded:
            np.testing.assert_allclose(g, w, atol=REGRID_TOL, rtol=0, err_msg=k)
        else:
            assert g.astype(np.float32).tobytes() == np.asarray(w, np.float32).tobytes(), k


# ---------------------------------------------------------------- the interps
@pytest.mark.parametrize("old,new", [((7, 7), (61, 5)), ((61, 5), (111, 5)), ((7, 7), (3, 2))])
def test_pos_grid_interp_matches_jax_to_fp32_rounding(old, new):
    pos = np.random.default_rng(0).standard_normal((1 + old[0] * old[1], W)).astype(np.float32)
    got = interp.slice_or_interp_pos_grid(torch.from_numpy(pos), old, new, use_slice=False).numpy()
    want = jax_interp.slice_or_interp_pos_grid(pos, old, new, use_slice=False)
    assert got.shape == want.shape == (1 + new[0] * new[1], W)
    assert np.array_equal(got[0], pos[0])  # the class row passes
    np.testing.assert_allclose(got, want, atol=REGRID_TOL, rtol=0)


@pytest.mark.parametrize("old,new", [((61, 5), (30, 5)), ((61, 5), (61, 5)), ((10, 5), (6, 5))])
def test_pos_grid_slice_is_bitwise_the_jax_window(old, new):
    """Only the time axis shrinks: the window starting 6 rows in, bitwise."""
    pos = np.random.default_rng(1).standard_normal((1 + old[0] * old[1], W)).astype(np.float32)
    got = interp.slice_or_interp_pos_grid(torch.from_numpy(pos), old, new).numpy()
    want = jax_interp.slice_or_interp_pos_grid(pos, old, new)
    assert got.tobytes() == np.asarray(want).tobytes()
    if old != new:
        assert np.array_equal(got[1:], pos[1 + 6 * old[1]: 1 + 6 * old[1] + new[0] * new[1]])


@pytest.mark.parametrize("new", [(40, 40), (16, 16), (32, 24), (32, 32)])
def test_conv_kernel_interp_matches_jax(new):
    k = np.random.default_rng(2).standard_normal((W, 3, 32, 32)).astype(np.float32)  # OIHW
    got = interp.interp_conv_kernel_spatial(torch.from_numpy(k), new).numpy()
    want = np.transpose(jax_interp.interp_conv_kernel_spatial(np.transpose(k, (2, 3, 1, 0)), new),
                        (3, 2, 0, 1))
    assert got.shape == want.shape == (W, 3, *new)
    np.testing.assert_allclose(got, want, atol=REGRID_TOL, rtol=0)


# ----------------------------------------------------------- the CLIP porters
def test_split_clip_state_dict_matches_jax(clip_sd):
    visual, text = clip_port.split_clip_state_dict(clip_sd)
    jv, jt = jax_clip_port.split_clip_state_dict(clip_sd)
    for got, want in ((visual, jv), (text, jt)):
        assert sorted(got) == sorted(want)
        assert all(got[k].numpy().tobytes() == want[k].tobytes() for k in want)
    assert "logit_scale" in text and not any(k.startswith("visual.") for k in visual)


# (geometry, use_slice, names re-gridded against CLIP's 7 x 7 grid of 32 x 32 patches)
VISUAL_CASES = {
    "image": ("image", True, ()),
    "audio_from_visual": ("audio", False, (POS,)),
    "audio_10s_from_visual": ("audio_10s", False, (POS,)),
    "audio_patch40": ("audio_p40", False, (POS, KERNEL)),
    "audio_patch16": ("audio_p16", False, (POS, KERNEL)),
    "audio_1ch": ("audio_1ch", False, (POS,)),
}


@pytest.mark.parametrize("case", sorted(VISUAL_CASES))
def test_port_clip_visual_matches_jax(clip_sd, case):
    geometry, use_slice, regridded = VISUAL_CASES[case]
    jt, pt = towers(geometry)
    visual, _ = clip_port.split_clip_state_dict(clip_sd)
    jv, _ = jax_clip_port.split_clip_state_dict(clip_sd)
    got = clip_port.port_clip_visual(visual, pt, use_slice=use_slice)
    want = jax_tree_sd(jax_clip_port.port_clip_visual(jv, jt, use_slice=use_slice))
    assert_same(got, want, regridded)
    assert got[POS].shape[0] == 1 + pt.grid[0] * pt.grid[1]
    assert got[KERNEL].shape[1] == 3  # CLIP's channels, whatever the tower's


def test_port_clip_text_matches_jax(clip_sd):
    jt, pt = towers("text")
    _, text = clip_port.split_clip_state_dict(clip_sd)
    _, jtext = jax_clip_port.split_clip_state_dict(clip_sd)
    got = clip_port.port_clip_text(text, pt)
    assert_same(got, jax_tree_sd(jax_clip_port.port_clip_text(jtext, jt)))
    assert got[POS].shape == (CTX, TEXT_W)  # the oracle's 77 positions cut to the context
    assert torch.equal(got[POS], clip_sd["positional_embedding"][:CTX])


@pytest.mark.parametrize("target,use_slice,regridded", [
    ("audio_18s", True, (POS,)),  # the time axis grows: interpolated
    ("audio_5s", True, ()),  # shrinks, freq equal: the window 6 rows in, bitwise
    ("audio_5s", False, (POS,)),
    ("audio_10s", True, ()),
    ("audio_p40", True, (POS, KERNEL)),
])
def test_port_audio_from_audio_matches_jax(clip_sd, target, use_slice, regridded):
    j10, p10 = towers("audio_10s")
    jt, pt = towers(target)
    visual, _ = clip_port.split_clip_state_dict(clip_sd)
    jv, _ = jax_clip_port.split_clip_state_dict(clip_sd)
    j_src = jax_clip_port.port_clip_visual(jv, j10, use_slice=False)["params"]
    p_src = clip_port.port_clip_visual(visual, p10, use_slice=False)
    assert_same(p_src, jax_tree_sd(j_src), (POS,))
    want = jax_tree_sd(jax_clip_port.port_audio_from_audio(j_src, j10.grid, jt, use_slice=use_slice))
    # from the JAX source grid, so that only this retarget is compared
    got = clip_port.port_audio_from_audio(
        {k: torch.from_numpy(np.array(v)) for k, v in jax_tree_sd(j_src).items()},
        p10.grid, pt, use_slice=use_slice)
    assert_same(got, want, regridded)
    assert got[POS].shape[0] == 1 + pt.grid[0] * pt.grid[1]


def test_a_clip_resnet_state_dict_is_refused_by_name():
    _, pt = towers("image")
    with pytest.raises(ValueError, match="ResNet"):  # into a ViT tower; a ResNet tower takes them
        clip_port.port_clip_visual({"conv1.weight": torch.zeros(1), "layer1.0.conv1.weight":
                                    torch.zeros(1), "attnpool.positional_embedding": torch.zeros(1)}, pt)


# ---------------------------------------------------- reference checkpoints
def _metahead_visual(visual_sd, geometry):
    """A visual tower in the MetaHead layout at ``geometry``'s grid, as the
    JAX package's exporter writes it."""
    jt, _ = towers(geometry)
    return jax_export_visual_sd(jax_clip_port.port_clip_visual(visual_sd, jt, use_slice=False)["params"])


REFERENCE_CASES = {
    # name -> (arity, audio layout, checkpoint cfg)
    "naive_2": (2, "naive", {"note": "synthetic"}),
    "metahead_2": (2, "metahead", None),
    "naive_2_cfg_grid": (2, "naive", {"model": {"audio": {"resolution": [224, 224],
                                                          "patch_size": 32}}}),
    "naive_4": (4, "naive", None),
    "metahead_4": (4, "metahead", {"model": {"audio": {"resolution": "${running.max_audio_len}"}}}),
}


def _reference_file(tmp_path, oracle, case):
    """A reference checkpoint (tests/test_reference_port.py's layouts) of
    the oracle's weights."""
    arity, layout, cfg = REFERENCE_CASES[case]
    visual, text, sd = oracle
    jv, _ = jax_clip_port.split_clip_state_dict(sd)
    audio = _naive_audio_sd(visual) if layout == "naive" else _metahead_visual(jv, "audio")
    loss = {"logit_scale": torch.tensor(1.2345)}
    model = (audio, loss) if arity == 2 else (_metahead_visual(jv, "image"), audio,
                                              _metahead_text_sd(text), loss)
    path = str(tmp_path / f"{case}.pth")
    torch.save({"cfg": cfg, "model": model}, path)
    return path


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_port_reference_matches_jax(tmp_path, oracle, case):
    path = _reference_file(tmp_path, oracle, case)
    cfg, payload = reference_port.load_torch_file(path)
    jcfg, jpayload = jax_reference_port.load_torch_file(path)
    parts = reference_port.split_reference_checkpoint(payload)
    jparts = jax_reference_port.split_reference_checkpoint(jpayload)
    arity = REFERENCE_CASES[case][0]
    assert sorted(parts) == sorted(jparts) == sorted(["audio", "loss"] if arity == 2 else
                                                     ["image", "audio", "text", "loss"])
    ja, pa = towers("audio")
    got = reference_port.port_reference_audio(parts["audio"], pa, cfg)
    want = jax_tree_sd(jax_reference_port.port_reference_audio(jparts["audio"], ja, jcfg))
    # the naive layout stores CLIP's 7 x 7 grid, the MetaHead one the tower's own 5 x 5
    assert_same(got, want, (POS,) if REFERENCE_CASES[case][1] == "naive" else ())
    if arity == 4:
        ji, pi = towers("image")
        assert_same(reference_port.port_reference_image(parts["image"], pi),
                    jax_tree_sd(jax_reference_port.port_reference_image(jparts["image"], ji)))
        jt, ptt = towers("text")
        assert_same(reference_port.port_reference_text(parts["text"], ptt),
                    jax_tree_sd(jax_reference_port.port_reference_text(jparts["text"], jt)))
    got_loss = reference_port.reference_loss_params(parts["loss"])
    want_loss = jax_reference_port.reference_loss_params(jparts["loss"])
    assert got_loss["logit_scale"].numpy().tobytes() == want_loss["logit_scale"].tobytes()


def test_a_checkpoint_of_another_arity_is_refused():
    for mod in (reference_port, jax_reference_port):
        with pytest.raises(ValueError, match="arity 3"):
            mod.split_reference_checkpoint(({}, {}, {}))


# ---------------------------------------------------------------- the export
def _jax_params(geometry, seed):
    jt, _ = towers(geometry)
    x = (jnp.zeros((1, CTX), jnp.int32) if geometry == "text"
         else jnp.zeros((1, 1, 100, 128) if geometry.startswith("audio") else (1, 3, 224, 224)))
    return jt.init(jax.random.PRNGKey(seed), x)["params"]


def _to_port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in jax_tree_sd(tree).items()}


@pytest.mark.parametrize("arity", [2, 4])
def test_export_reference_pth_matches_the_jax_export(tmp_path, arity):
    j = {"audio": _jax_params("audio", 0), "loss": {"logit_scale": np.float32(2.659)}}
    if arity == 4:
        j.update(image=_jax_params("image", 1), text=_jax_params("text", 2))
    p = {k: (_to_port(v) if k != "loss" else {"logit_scale": torch.tensor(2.659)}) for k, v in j.items()}
    jcfg, pcfg = (jax_compose(TINY_MODEL + ["+running=bimodal", "+model/loss=ce"]),
                  compose(TINY_MODEL + ["+running=bimodal", "+model/loss=ce"]))
    jax_export_reference_pth(str(tmp_path / "jax.pth"), j, cfg=jcfg)
    reference_export.export_reference_pth(str(tmp_path / "port.pth"), p, cfg=pcfg)
    want = torch.load(tmp_path / "jax.pth", weights_only=False)
    got = torch.load(tmp_path / "port.pth", weights_only=False)
    assert got["cfg"] == want["cfg"] and isinstance(got["cfg"], dict)
    assert len(got["model"]) == len(want["model"]) == arity
    for g, w in zip(got["model"], want["model"]):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype == torch.float32 and g[k].shape == w[k].shape, k
            assert torch.equal(g[k], w[k]), k


def test_export_writes_empty_parts_in_a_four_tuple(tmp_path):
    path = str(tmp_path / "x.pth")
    reference_export.export_reference_pth(path, {"audio": _to_port(_jax_params("audio", 0)),
                                                 "text": {}})
    model = torch.load(path, weights_only=False)["model"]
    assert len(model) == 4 and model[0] == model[2] == model[3] == {} and model[1]
    with pytest.raises(KeyError, match="decoder"):
        reference_export.export_reference_pth(path, {"decoder": {}})


def _forward_pair(jt, jparams, pt, x):
    want = np.asarray(jt.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = pt(torch.from_numpy(x)).numpy()
    return got, want


def _audio_input(seed=0):
    return np.random.default_rng(seed).standard_normal((3, 1, 100, 128)).astype(np.float32)


def _text_input():
    ids = np.zeros((3, CTX), np.int64)
    ids[:, 0], ids[:, 1:6], ids[:, 6] = 49406, np.arange(1, 16).reshape(3, 5), 49407
    return ids


def test_the_ports_pth_loads_in_the_jax_package_and_gives_the_ports_forward(tmp_path):
    """Port towers (seeded random) -> the port's .pth -> the JAX loader -> the
    JAX forward, against the port's forward."""
    g = torch.Generator().manual_seed(3)
    ja, pa = towers("audio")
    ji, pi = towers("image")
    jt, ptt = towers("text")
    for t in (pa, pi, ptt):
        init_weights(t, g).eval()
    path = str(tmp_path / "port.pth")
    reference_export.export_reference_pth(path, {
        "image": pi.state_dict(), "audio": pa.state_dict(), "text": ptt.state_dict(),
        "loss": {"logit_scale": torch.tensor(3.0)}})
    jcfg, payload = jax_reference_port.load_torch_file(path)
    parts = jax_reference_port.split_reference_checkpoint(payload)
    x, ids = _audio_input(), _text_input()
    for jtower, ptower, params, inp in (
            (ja, pa, jax_reference_port.port_reference_audio(parts["audio"], ja, jcfg)["params"], x),
            (jt, ptt, jax_reference_port.port_reference_text(parts["text"], jt)["params"], ids),
            (ji, pi, jax_reference_port.port_reference_image(parts["image"], ji)["params"],
             np.random.default_rng(4).standard_normal((2, 3, 224, 224)).astype(np.float32))):
        got, want = _forward_pair(jtower, params, ptower,
                                  inp.astype(np.int32) if inp.dtype == np.int64 else inp)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=FORWARD_TOL, rtol=0)


def test_the_jax_pth_loads_in_the_port_and_gives_the_jax_forward(tmp_path):
    ja, pa = towers("audio")
    jt, ptt = towers("text")
    j = {"audio": _jax_params("audio", 5), "text": _jax_params("text", 6), "loss":
         {"logit_scale": np.float32(1.5)}}
    path = str(tmp_path / "jax.pth")
    jax_export_reference_pth(path, j)
    model = build_main_model(compose(["+running=clotho", "worker=CLAP", *_tiny_clap()]),
                             device="cpu").eval()
    loaded = loading.apply_reference_ckpt(model, path)
    assert loaded == ["audio", "text"] and model.loss.logit_scale.item() == 1.5
    for jtower, ptower, params, inp in ((ja, model.audio, j["audio"], _audio_input(1)),
                                        (jt, model.text, j["text"], _text_input())):
        want = np.asarray(jtower.apply({"params": params}, jnp.asarray(
            inp.astype(np.int32) if inp.dtype == np.int64 else inp)))
        with torch.no_grad():
            got = ptower(torch.from_numpy(inp)).numpy()
        np.testing.assert_allclose(got, want, atol=FORWARD_TOL, rtol=0)


# ------------------------------------------------------------- TorchScript
class _TinyClip(torch.nn.Module):
    """A CLIP-named module to script: its state dict is the oracle's."""

    def __init__(self, sd):
        super().__init__()
        for name, value in sd.items():
            *path, leaf = name.split(".")
            mod = self
            for p in path:
                if not hasattr(mod, p):
                    mod.add_module(p, torch.nn.Module())
                mod = getattr(mod, p)
            mod.register_parameter(leaf, torch.nn.Parameter(value.clone(), requires_grad=False))

    def forward(self, x):
        return x * self.logit_scale


@pytest.fixture(scope="module")
def torchscript_clip(clip_sd, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jit") / "tinyjit.pt")
    torch.jit.save(torch.jit.trace(_TinyClip(clip_sd), torch.ones(2)), path)
    return path


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    assert all(torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])) for k in want)


def test_a_torchscript_archive_loads_like_a_state_dict(torchscript_clip, clip_sd, monkeypatch):
    with pytest.warns(UserWarning, match="TorchScript"):  # torch.load hands it to jit.load
        cfg, sd = reference_port.load_torch_file(torchscript_clip)
    assert cfg is None
    _assert_state_dicts_equal(sd, clip_sd)
    with pytest.warns(UserWarning, match="TorchScript"):
        _assert_state_dicts_equal(jax_reference_port.load_torch_file(torchscript_clip)[1], sd)

    def refuse(*a, **k):  # a torch.load that does not take archives: the jit.load fallback
        raise RuntimeError("not a pickle")

    monkeypatch.setattr(torch, "load", refuse)
    _, via_jit = reference_port.load_torch_file(torchscript_clip)
    _assert_state_dicts_equal(via_jit, clip_sd)


# ------------------------------------------------------------------ the zoo
def test_the_zoo_table_is_the_originals():
    assert zoo._MODELS == jax_zoo._MODELS


def _answer(fn):
    try:
        return ("ok", fn())
    except (FileNotFoundError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def test_zoo_resolve_answers_as_the_jax_package(tmp_path, monkeypatch):
    payload = b"fabricated clip weights"
    entry = ("Fake-B-32.pt", hashlib.sha256(payload).hexdigest())
    for m in (zoo, jax_zoo):
        monkeypatch.setitem(m._MODELS, "Fake-B32", entry)
    root = str(tmp_path)
    both = lambda *a, **k: (_answer(lambda: zoo.resolve(*a, **k)),
                            _answer(lambda: jax_zoo.resolve(*a, **k)))
    for step in ("missing", "good", "corrupt"):
        if step != "missing":
            (tmp_path / "Fake-B-32.pt").write_bytes(payload if step == "good" else b"corrupt")
        for args in (("NotAModel", root), ("Fake-B32", root), ("Fake-B32", root, False)):
            got, want = both(*args)
            assert got == want, (step, args)
    assert both("Fake-B32", root)[0][0] == "RuntimeError"


def _clip_cfg(cls, root, name, **extra):
    return cls({"running": {"clip_model_root": root, "clip_model_name": name, **extra}})


def _with_warnings(fn, cfg):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        return fn(cfg), [str(x.message) for x in w]


def test_clip_weights_path_answers_as_the_jax_package(tmp_path, monkeypatch):
    payload = b"zoo artifact"
    entry = ("Fake-B-32.pt", hashlib.sha256(payload).hexdigest())
    for m in (zoo, jax_zoo):
        monkeypatch.setitem(m._MODELS, "Fake-B32", entry)
    root = str(tmp_path)

    def both(name, **extra):
        got, w1 = _with_warnings(loading.clip_weights_path, _clip_cfg(Config, root, name, **extra))
        want, w2 = _with_warnings(jax_clip_weights_path, _clip_cfg(JaxConfig, root, name, **extra))
        assert (got, w1) == (want, w2), (name, extra)
        return got, len(w1)

    assert both("Fake-B32") == (None, 0)  # a zoo name whose file is absent
    (tmp_path / "Fake-B-32.pt").write_bytes(payload)
    assert both("Fake-B32") == (str(tmp_path / "Fake-B-32.pt"), 0)
    (tmp_path / "Fake-B-32.pt").write_bytes(b"oops")
    assert both("Fake-B32") == (None, 1)  # the digest differs: warned, no plain file
    assert both("Fake-B32", clip_verify_sha=False) == (str(tmp_path / "Fake-B-32.pt"), 0)
    (tmp_path / "Fake-B32.pt").write_bytes(b"finetuned")
    assert both("Fake-B32") == (str(tmp_path / "Fake-B32.pt"), 1)
    assert both("my_finetune") == (None, 0)
    (tmp_path / "my_finetune.pth").write_bytes(b"anything")
    assert both("my_finetune") == (str(tmp_path / "my_finetune.pth"), 0)
    assert both("") == (None, 0)
    for cls, fn in ((Config, loading.clip_weights_path), (JaxConfig, jax_clip_weights_path)):
        assert fn(cls({})) is None


def test_the_shipped_clip_root_moves_under_tmpdir(tmp_path, monkeypatch):
    """``/tmp/clip``, the running configs' default, resolves under TMPDIR
    as the port's other shipped paths do (the JAX package reads /tmp/clip)."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    (tmp_path / "clip").mkdir()
    (tmp_path / "clip" / "mine.pt").write_bytes(b"x")
    assert loading.clip_weights_path(_clip_cfg(Config, "/tmp/clip", "mine")) == str(
        tmp_path / "clip" / "mine.pt")


# -------------------------------------------------------- the model porter
def _tiny_clap():
    return ["+model/image=vit_val", "+model/audio=vit_val", "+model/text=transformer_val",
            "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
            f"model.image.width={W}", f"model.image.embed_dim={EMB}",
            f"model.image.encoder.layers={LAYERS}", f"model.image.heads={HEADS}",
            f"model.text.width={TEXT_W}", f"model.text.embed_dim={EMB}",
            f"model.text.encoder.layers={LAYERS}", f"model.text.heads={HEADS}",
            f"model.text.ctx_len={CTX}", "running.audio.max_len=100",
            "model.audio.pre_encoder.stride=[16,24]", "compute_dtype=float32", "model_file="]


def _tiny_cvap(*extra):
    return ["+running=bimodal", *_tiny_clap(), "worker=CVAP", "+model/text=dummy", *extra]


@pytest.fixture(scope="module")
def clip_root(clip_sd, tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    torch.save(clip_sd, root / "tinyclip.pt")
    return str(root)


def _with_clip(root, name="tinyclip"):
    return [f"running.clip_model_root={root}", f"running.clip_model_name={name}"]


@pytest.fixture(scope="module")
def jax_clap(clip_root):
    """The JAX engine on the tiny CLAP config, seeded from the CLIP file."""
    return JaxEngine(["+running=clotho", "worker=CLAP", *_tiny_clap(), *_with_clip(clip_root)],
                     batch_size=4)


def _jax_model_sd(variables, towers_=("image", "audio", "text", "loss")):
    return from_jax.model_state_dict({k: v for k, v in variables["params"].items() if k in towers_})


def test_the_engine_seeds_every_tower_from_clip_as_the_jax_engine(jax_clap, clip_root):
    eng = InferenceEngine(["+running=clotho", "worker=CLAP", *_tiny_clap(), *_with_clip(clip_root)],
                          batch_size=4, device="cpu")
    want = _jax_model_sd(jax_clap.variables)
    got = dict(eng.model.named_parameters())
    assert_same(got, want, ("audio." + POS,))
    # CLIP's logit_scale went into the loss head: not the seeded init
    assert eng.model.loss.logit_scale.item() == pytest.approx(np.log(1 / 0.07))
    fb = np.random.default_rng(0).standard_normal((5, 100, 128)).astype(np.float32)
    np.testing.assert_allclose(eng.embed_audio(fb), np.asarray(jax_clap.embed_audio(fb)),
                               atol=FORWARD_TOL, rtol=0)
    texts = ["a dog barking", "rain on a roof", "a car"]
    np.testing.assert_allclose(eng.embed_texts(texts), np.asarray(jax_clap.embed_texts(texts)),
                               atol=FORWARD_TOL, rtol=0)


def test_port_model_from_clip_fills_every_logit_scale(clip_sd):
    cfg = compose(["+running=clotho", "worker=CLAP", *_tiny_clap(), "+model/text=transformer_decoder",
                   "+model/loss=ce_lm", "model.text.width=32", "model.text.heads=4",
                   "model.text.layers=2", "model.text.mem_width=64", "running.retrieval=False"])
    model = build_main_model(cfg, device="cpu")
    assert port_model_from_clip(model, clip_sd) == ["audio"]  # a decoder is not CLIP's text tower
    assert model.lm_loss.logit_scale.item() == clip_sd["logit_scale"].item()


def test_a_one_channel_tower_keeps_clips_three_channel_kernel(clip_sd, clip_root):
    """``in_channels: 1`` (model/audio/vit.yaml): the tower takes CLIP's
    3-channel kernel as its parameter and its channel mean at every forward;
    the trainer's optimizer holds and steps that leaf. The JAX porter gives
    the same tensors, but the JAX 1-channel tower refuses the 3-channel
    kernel at its first apply (flax's parameter shape check): its forward is
    the 3-channel tower's on the 1-channel input, which collapses alike."""
    _, pa = towers("audio_1ch")
    ja, _ = towers("audio")
    visual, _ = clip_port.split_clip_state_dict(clip_sd)
    jv, _ = jax_clip_port.split_clip_state_dict(clip_sd)
    jparams = jax_clip_port.port_clip_visual(jv, ja, use_slice=False)["params"]
    before = pa.pre_encoder.conv1.weight
    loading.load_tower(pa, clip_port.port_clip_visual(visual, pa, use_slice=False), "audio")
    after = pa.pre_encoder.conv1.weight
    assert before.shape[1] == 1 and after is not before and after.shape == (W, 3, 32, 32)
    assert torch.equal(after, clip_sd["visual.conv1.weight"])
    got, want = _forward_pair(ja, jparams, pa.eval(), _audio_input(2))
    np.testing.assert_allclose(got, want, atol=FORWARD_TOL, rtol=0)

    tr = Trainer(one_rank(_tiny_cvap("model.audio.pre_encoder.in_channels=1", "running.batch_size=2",
                                     "optimizer.warmup_epoch=0", *_with_clip(clip_root))), device="cpu")
    leaf = tr.trainable["audio." + KERNEL]
    assert leaf is tr.model.audio.pre_encoder.conv1.weight and leaf.shape == (W, 3, 32, 32)
    r = np.random.default_rng(0)
    start = leaf.detach().clone()
    tr.train_step(*tr.make_batch(r.standard_normal((2, 3, 224, 224)).astype(np.float32),
                                 r.standard_normal((2, 1, 100, 128)).astype(np.float32)))
    assert not torch.equal(leaf, start)
    with pytest.raises(ValueError, match="shape"):  # any other mismatch is refused
        loading.load_tower(pa, {**dict(pa.named_parameters()), POS: torch.zeros(3, W)}, "audio")


# ------------------------------------------------------ the engine's order
def _echo():
    """A logger that reaches the root logger (and pytest's ``caplog``)."""
    return logging.getLogger("test_torch_ckpt")


def test_the_engine_loads_a_pth_from_the_run_dir_or_a_direct_path(tmp_path, oracle):
    path = _reference_file(tmp_path, oracle, "naive_4")
    os.makedirs(tmp_path / "runs" / "m")
    os.replace(path, tmp_path / "runs" / "m" / "x.pth")
    base = ["+running=clotho", "worker=CLAP", *_tiny_clap()]
    a = InferenceEngine(base + [f"model_root={tmp_path}/runs", "model_name=m", "model_file=x.pth"],
                        batch_size=4, device="cpu")
    b = InferenceEngine(base + [f"model_file={tmp_path}/runs/m/x.pth"], batch_size=4, device="cpu")
    jcfg, payload = jax_reference_port.load_torch_file(str(tmp_path / "runs" / "m" / "x.pth"))
    jparts = jax_reference_port.split_reference_checkpoint(payload)
    (ja, _), (jt, _) = towers("audio"), towers("text")
    want_audio = jax_tree_sd(jax_reference_port.port_reference_audio(jparts["audio"], ja, jcfg))
    want_text = jax_tree_sd(jax_reference_port.port_reference_text(jparts["text"], jt))
    for eng in (a, b):
        assert_same(dict(eng.model.audio.named_parameters()), want_audio, (POS,))
        assert_same(dict(eng.model.text.named_parameters()), want_text)
        assert eng.model.loss.logit_scale.item() == pytest.approx(1.2345)
    with pytest.raises(FileNotFoundError, match="direct path"):
        InferenceEngine(base + ["model_file=nowhere.pth"], batch_size=4, device="cpu")


def test_an_engine_without_clip_keeps_the_seeded_init_and_says_so(caplog):
    cfg = ["+running=clotho", "worker=CLAP", *_tiny_clap(), "running.clip_model_name="]
    with caplog.at_level(logging.INFO, logger="test_torch_ckpt"):
        a = InferenceEngine(cfg, batch_size=4, device="cpu", seed=3, echo=_echo())
    b = InferenceEngine(cfg, batch_size=4, device="cpu", seed=3)
    own = dict(b.model.named_parameters())
    assert all(torch.equal(p, own[k]) for k, p in a.model.named_parameters())
    assert "audio: seeded random init" in caplog.text
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]


def test_a_pth_that_leaves_towers_out_warns(tmp_path, oracle, caplog):
    path = _reference_file(tmp_path, oracle, "naive_2")
    with caplog.at_level(logging.INFO, logger="test_torch_ckpt"):
        InferenceEngine(["+running=clotho", "worker=CLAP", *_tiny_clap(), f"model_file={path}"],
                        batch_size=4, device="cpu", echo=_echo())
    warned = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warned) == 1 and "['text'] stay at the seeded random init" in warned[0]


@pytest.fixture(scope="module")
def audio_export(tmp_path_factory):
    """A step directory whose model.npz covers the audio tower and the loss
    head only (the VA trainer's export), without a state.pt."""
    root = str(tmp_path_factory.mktemp("npz"))
    tr = Trainer(one_rank(_tiny_cvap("running.batch_size=2", "running.clip_model_name=",
                                     f"alias_root={root}", "model_name=run")), device="cpu")
    step = tr.save()
    os.remove(os.path.join(step, "state.pt"))
    return tr, [f"model_root={root}", "model_name=run", f"model_file={os.path.basename(step)}"]


def test_the_towers_a_weight_export_leaves_out_come_from_clip_as_in_jax(audio_export, clip_root):
    tr, at_step = audio_export
    over = _tiny_cvap(*_with_clip(clip_root), *at_step)
    eng = InferenceEngine(over, batch_size=4, device="cpu")
    jeng = JaxEngine(over, batch_size=4)
    got = dict(eng.model.named_parameters())
    assert_same(got, _jax_model_sd(jeng.variables))
    for k, p in tr.model.named_parameters():  # the export's towers are the trainer's
        if k.split(".")[0] in ("audio", "loss"):
            assert torch.equal(p, got[k]), k
    with pytest.raises(ValueError, match="no CLIP"):  # no CLIP and no state.pt: refused
        InferenceEngine(_tiny_cvap("running.clip_model_name=", *at_step), batch_size=4, device="cpu")


# ----------------------------------------------------- the trainer's order
@pytest.fixture(scope="module")
def jax_va(clip_root, tmp_path_factory):
    """The JAX VA trainer on the tiny config, seeded from the CLIP file."""
    run = str(tmp_path_factory.mktemp("jaxva"))
    return jax_build_monitor(jax_compose(_tiny_cvap(
        *_with_clip(clip_root), "monitor=VAMonitor", "running.batch_size=2", "running.data_name=",
        "running.eval_name=", "eval=True", f"alias_root={run}", f"model_root={run}")))


def test_the_trainer_seeds_from_clip_as_the_jax_trainer(jax_va, clip_root):
    tr = Trainer(one_rank(_tiny_cvap("running.batch_size=2", *_with_clip(clip_root))), device="cpu")
    want = from_jax.model_state_dict(jax.tree_util.tree_map(np.asarray, jax_va.state.full_params()))
    assert_same({**tr.trainable, **tr.frozen}, want, ("audio." + POS,))
    assert set(tr.frozen) == {k for k in want if k.startswith("image.")}


def test_the_trainer_loads_a_pth_and_not_clip(tmp_path, oracle, clip_root):
    path = _reference_file(tmp_path, oracle, "naive_2_cfg_grid")
    tr = Trainer(one_rank(_tiny_cvap("running.batch_size=2", *_with_clip(clip_root),
                                     f"model_file={path}")), device="cpu")
    seeded = Trainer(one_rank(_tiny_cvap("running.batch_size=2", "running.clip_model_name=")), device="cpu")
    jcfg, payload = jax_reference_port.load_torch_file(path)
    ja, _ = towers("audio")
    want = jax_tree_sd(jax_reference_port.port_reference_audio(
        jax_reference_port.split_reference_checkpoint(payload)["audio"], ja, jcfg))
    assert_same({k[len("audio."):]: v for k, v in tr.trainable.items() if k.startswith("audio.")},
                want, (POS,))
    # model_file is set: CLIP does not seed the image tower, as in the JAX trainer
    assert all(torch.equal(p, seeded.frozen[k]) for k, p in tr.frozen.items())
    assert tr.trainable["loss.logit_scale"].item() == pytest.approx(1.2345)
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        Trainer(one_rank(_tiny_cvap("model_file=missing.pth")), device="cpu")


def test_export_pth_writes_a_two_tuple_both_packages_load(tmp_path, clip_root):
    tr = Trainer(one_rank(_tiny_cvap("running.batch_size=2", *_with_clip(clip_root), "export_pth=True",
                                     f"alias_root={tmp_path}", "model_name=va")), device="cpu")
    r = np.random.default_rng(1)
    tr.train_step(*tr.make_batch(r.standard_normal((2, 3, 224, 224)).astype(np.float32),
                                 r.standard_normal((2, 1, 100, 128)).astype(np.float32)))
    tr.global_step = 1
    step = tr.save()
    pth = os.path.join(step, "00000001.pth")
    assert sorted(os.listdir(step)) == ["00000001.pth", "COMMITTED", "config.json", "model.npz",
                                        "state.pt"]
    ckpt = torch.load(pth, weights_only=False)
    assert len(ckpt["model"]) == 2 and isinstance(ckpt["cfg"], dict)
    audio, loss = ckpt["model"]
    own = dict(tr.model.named_parameters())
    assert sorted(audio) == sorted(k[len("audio."):] for k in own if k.startswith("audio."))
    assert all(torch.equal(v, own["audio." + k]) for k, v in audio.items())
    assert sorted(loss) == ["logit_scale"] and torch.equal(loss["logit_scale"], own["loss.logit_scale"])
    # the JAX package reads it: its audio tower is the port's
    jeng = JaxEngine(_tiny_cvap("running.clip_model_name="), batch_size=2)
    jvars = jax_apply_reference_ckpt(jeng.model, jeng.variables, pth)
    assert_same(audio, jax_tree_sd(jvars["params"]["audio"]))
    # and a port trainer started from it holds the audio tower bitwise
    again = Trainer(one_rank(_tiny_cvap("running.batch_size=2", f"model_file={pth}")), device="cpu")
    assert all(torch.equal(again.trainable["audio." + k], v) for k, v in audio.items())


def test_an_la_monitor_starts_from_a_va_pth(tmp_path, oracle):
    """The AT recipe: ``LAMonitor`` with ``model_file=<VA .pth>`` takes the
    audio tower from it and trains."""
    path = _reference_file(tmp_path, oracle, "metahead_2")
    mon = build_monitor(one_rank(["+running=clotho", "worker=CLAP", "monitor=LAMonitor", *_tiny_clap(),
                                  f"model_file={path}", "running.batch_size=2", "eval=False",
                                  "running.data_name=", "running.eval_name="]),
                        device="cpu", steps_per_epoch=4)
    audio = torch.load(path, weights_only=False)["model"][0]
    assert all(torch.equal(mon.trainable["audio." + k], torch.as_tensor(v)) for k, v in audio.items())
    r = np.random.default_rng(2)
    ids = np.zeros((2, CTX), np.int64)
    ids[:, 0], ids[:, 1:4], ids[:, 4] = 49406, r.integers(1, 49406, (2, 3)), 49407
    m = mon.train_step(*mon.make_batch(r.standard_normal((2, 1, 100, 128)).astype(np.float32), ids))
    assert np.isfinite(float(m["loss"]))
