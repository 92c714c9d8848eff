"""The port's classification path (ESC-50 / US8K / AudioSet-eval / VoxCeleb2
x-fold, AudioSet multi-label) against the JAX package, on the CPU, at a
small size (towers of width 64 / 32, 2 layers, 100 x 128 fbanks) in fp32:

- the heads (``ClassificationHead``, ``BCELossHead``, ``BCHingeLossHead``,
  ``ImagineAndClassifyLossHead``, each built by both packages'
  ``build_loss_head`` from its YAML, with MLP layers where it takes them),
  the JAX params carried over by ``ckpt/from_jax``: the loss, the
  ``ce`` / ``bce`` parts, the grads of every param and of the input, and
  the eval outputs (logits, sigmoid scores) within 1e-5;
- a training step of ``ESClassifier`` and ``ASClassifier`` (with and
  without the imagine branch) through the monitors' train state against
  ``jax.value_and_grad`` of the JAX model on the same batch: loss and parts
  within rtol 1e-5, every trainable grad by name within rtol 1e-3, atol
  1e-3 * max |grad| (another fp32 summation order through two layers, the
  bound of tests/test_torch_train.py);
- the data layer: ``build_xfold_dataloader_list`` for ESC-50, US8K (written
  here), the AudioSet eval fold, VoxCeleb2 and a JSONL fold gives the JAX
  package's records, classes, prompt ids and zero-shot collapse map (with a
  multi-prompt ``meta/{prompt}.json`` too); ``AudioLabelDataset`` items
  (train, with SpecAugment, under one ``np.random`` seed; and eval) and the
  collated batch bitwise the JAX package's on the NumPy fbank
  (``tests/fbank_route.py``); the AudioSet label map and token matrix, the
  three filter-set formats, ``label_counts``, ``sampling_weights``, the
  label-distribution table, the weighted loader's indices per epoch, the
  mixup item (Beta(10, 10), soft labels) and the contrastive item under one
  seed, and the collator, all bitwise; the definitions the copies keep
  unchanged are the same code;
- the monitors on the JAX weights (``from_jax``): ``ESCMonitor``'s prompt
  and per-fold audio embeddings within 1e-5, its pooled and per-fold
  zero-shot P@1 and its supervised P@1 equal to the JAX monitor's, the
  eval passes trimmed to the true clip count; ``summary_report`` of a fixed
  trace as the JAX monitor's; ``ASMonitor``'s multilabel and zero-shot
  report strings equal to the JAX monitor's; the supervised x-fold run on
  two tone classes beats chance (as tests/test_learning.py holds the JAX
  package's, at a size that runs in seconds);
- ``InferenceEngine`` with ``worker=ESClassifier`` and ``ASClassifier``:
  ``embed_audio``, ``embed_texts`` and ``zero_shot`` within 1e-4 of the JAX
  engine's on the same weights (tests/test_torch_serve.py's fp32 bound);
- the refusals: a contrastive (``clf=False``) ``pak*`` AudioSet dataset is
  refused as the JAX package refuses it.
"""

import ast
import inspect
import json
import logging
import os
import re
import warnings

import jax
import numpy as np
import pytest
import torch

from vipant_tpu.config import compose as jax_compose
from vipant_tpu.data import audioset as jax_audioset
from vipant_tpu.data import esc50 as jax_esc50
from vipant_tpu.models import build_main_model as jax_build_model, init_model
from vipant_tpu.nn import losses as jax_losses
from vipant_tpu.serve import InferenceEngine as JaxEngine
from vipant_tpu.train import build_monitor as jax_build_monitor
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.data import audioset, esc50
from vipant_tpu_torch.data.wav import write_wav
from vipant_tpu_torch.nn import losses
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import ASTrainer, ESCTrainer, build_monitor, loss_aux_and_grads

from data_synth import (make_synth_audioset, make_synth_audioset_eval, make_synth_esc50,
                        make_synth_voxceleb2)
from fbank_route import pin_numpy_fbank

TINY = [
    "+model/image=vit_val", "+model/audio=vit_val", "+model/text=transformer_val",
    "+optimizer=standard", "+running/audio=default", "model.image.width=64",
    "model.image.embed_dim=32", "model.image.encoder.layers=2", "model.image.heads=4",
    "model.text.width=32", "model.text.heads=4", "model.text.encoder.layers=2",
    "running.audio.max_len=100", "model.audio.pre_encoder.stride=[16,24]",
    "optimizer.use_lars=False", "optimizer.warmup=False", "num_proc=2", "compute_dtype=float32",
]
ESC = ["+running=esc50", *TINY, "+model/loss=ce_cls", "worker=ESClassifier", "monitor=ESCMonitor",
       "running.batch_size=4"]
AS = ["+running=audioset", *TINY, "+model/loss=imagine_and_classify", "worker=ASClassifier",
      "monitor=ASMonitor", "running.batch_size=4", "running.test_name="]
CLASSES = ("dog", "rain", "siren")
HEAD_TOL = 1e-5
STEP_RTOL = 1e-5  # the loss and its parts
GRAD_RTOL = 1e-3  # per grad, with atol GRAD_RTOL * max |grad|
ENGINE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _numpy_fbank():
    mp = pytest.MonkeyPatch()
    pin_numpy_fbank(mp)
    yield
    mp.undo()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _write_us8k(root, per_class=2):
    rows = ["slice_file_name,fsID,start,end,salience,fold,classID,class"]
    for cid, name in enumerate(("air_conditioner", "car_horn", "dog_bark")):
        for j in range(per_class):
            fold = j % 3 + 1
            fname = f"{cid}-{j}.wav"
            os.makedirs(os.path.join(root, "audio", f"fold{fold}"), exist_ok=True)
            t = np.arange(16800) / 16000.0
            write_wav(os.path.join(root, "audio", f"fold{fold}", fname),
                      (0.3 * np.sin(2 * np.pi * (200 + 150 * cid) * t)).astype(np.float32), 16000)
            rows.append(f"{fname},1,0,1,1,{fold},{cid},{name}")
    with open(os.path.join(root, "us8k.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def _write_jsonl_fold(root, name="clips"):
    os.makedirs(os.path.join(root, "sub", "aclip"), exist_ok=True)
    with open(os.path.join(root, f"{name}.jsonl"), "w") as f:
        for i, cls in enumerate(("bird", "bell", "bird", "wind")):
            t = np.arange(16800) / 16000.0
            write_wav(os.path.join(root, "sub", "aclip", f"c{i}.wav"),
                      (0.2 * np.sin(2 * np.pi * (300 + 90 * i) * t)).astype(np.float32), 16000)
            f.write(json.dumps({"id": f"c{i}", "dir": "sub", "class": cls}) + "\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Roots: ESC-50 (3 classes x 3 clips, 2 folds; 2 tone classes x 6
    clips), US8K (3 folds), a JSONL
    fold, the AudioSet eval fold, VoxCeleb2, an AudioSet train index."""
    d = {k: str(tmp_path_factory.mktemp(k))
         for k in ("esc", "tones", "us8k", "jsonl", "aseval", "vox", "as")}
    make_synth_esc50(d["esc"], n_per_class=3, classes=CLASSES, seconds=1.05)
    make_synth_esc50(d["tones"], n_per_class=6, seconds=1.05)  # tests/test_learning.py's
    os.makedirs(os.path.join(d["esc"], "meta"))
    with open(os.path.join(d["esc"], "meta", "multi.json"), "w") as f:
        json.dump({c: [f"a photo of {c}", f"the sound of a {c}", f"{c} noise", f"a loud {c}", "extra"]
                   for c in CLASSES}, f)
    _write_us8k(d["us8k"])
    _write_jsonl_fold(d["jsonl"])
    make_synth_audioset_eval(d["aseval"], "audioset", n=6, seconds=1.05)
    make_synth_voxceleb2(d["vox"], n_speakers=3, n_vids=2, n_clips=3, seconds=1.05)
    make_synth_audioset(d["as"], "as_train", n=8, seconds=1.05)
    return d


def _cfgs(over):
    return compose(over), jax_compose(over)


# ------------------------------------------------------------------ heads
HEADS = {
    "ClassificationHead": ["+model/loss=ce_cls"],
    "BCELossHead": ["+model/loss=bce", "model.loss.layers=[16]", "model.loss.bias=True"],
    "BCHingeLossHead": ["+model/loss=bce", "model.loss.name=BCHingeLossHead", "model.loss.layers=[16]"],
    "ImagineAndClassifyLossHead": ["+model/loss=imagine_and_classify", "model.loss.bce.layers=[16]"],
}
B, D, L = 6, 32, 5


def _head_inputs(name):
    r = np.random.default_rng(3)
    x = r.standard_normal((B, D)).astype(np.float32)
    if name == "ClassificationHead":
        labels = r.integers(0, L, B).astype(np.int32)
    else:
        labels = (r.random((B, L)) < 0.4).astype(np.float32)
        labels[0] = 0.0  # an item with no positive label
    image = r.standard_normal((B, D)).astype(np.float32)
    return x, labels, image / np.linalg.norm(image, axis=-1, keepdims=True)


@pytest.fixture(scope="module", params=sorted(HEADS))
def heads(request):
    name = request.param
    port_cfg, jax_cfg = _cfgs(["+running=audioset", *TINY, *HEADS[name]])
    assert port_cfg.model.loss.name == name
    jhead = jax_losses.build_loss_head(jax_cfg.model.loss, output_dim=L)
    head = losses.build_loss_head(port_cfg.model.loss, in_dim=D, num_labels=L)
    x, labels, image = _head_inputs(name)
    imagine = name == "ImagineAndClassifyLossHead"
    args = (x, labels, image) if imagine else (x, labels)
    params = _np(jhead.init(jax.random.PRNGKey(1), *args, train=True)["params"])
    head.load_state_dict({k: torch.tensor(v) for k, v in from_jax.loss_state_dict(params).items()},
                         strict=True)
    return name, jhead, head, params, args


def test_heads_build_with_the_jax_names(heads):
    name, _, head, params, _ = heads
    assert type(head).__name__ == name
    assert sorted(dict(head.named_parameters())) == sorted(from_jax.loss_state_dict(params))
    back = from_jax.to_jax_params({f"loss.{k}": p for k, p in head.state_dict().items()})["loss"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)


def test_head_loss_and_grads_match_the_jax_head(heads):
    name, jhead, head, params, args = heads
    imagine = name == "ImagineAndClassifyLossHead"

    def jloss(p, x):
        out = jhead.apply({"params": p}, x, *args[1:], train=True)
        return out if imagine else (out, {})

    (jl, jaux), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(params, args[0])
    x = torch.tensor(args[0], requires_grad=True)
    out = head(x, *(torch.tensor(a) for a in args[1:]), train=True)
    loss, aux = out if imagine else (out, {})
    loss.backward()
    assert abs(loss.item() - float(jl)) <= HEAD_TOL * max(1.0, abs(float(jl)))
    assert sorted(aux) == sorted(jaux) == (["bce", "ce"] if imagine else [])
    for k in aux:
        assert abs(aux[k].item() - float(jaux[k])) <= HEAD_TOL * max(1.0, abs(float(jaux[k])))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), rtol=0, atol=HEAD_TOL)
    want = from_jax.loss_state_dict(_np(jgp))
    got = {k: p.grad for k, p in head.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0, atol=HEAD_TOL, err_msg=k)


def test_head_eval_outputs_match_the_jax_head(heads):
    name, jhead, head, params, args = heads
    want = np.asarray(jhead.apply({"params": params}, *args[:2], train=False))
    with torch.no_grad():
        got = head(torch.tensor(args[0]), torch.tensor(args[1]), train=False).numpy()
    assert got.shape == want.shape == (B, L)
    np.testing.assert_allclose(got, want, rtol=0, atol=HEAD_TOL)
    if name != "ClassificationHead":  # sigmoid scores
        assert (got >= 0).all() and (got <= 1).all()


def test_a_classifier_head_needs_the_label_count():
    port_cfg, _ = _cfgs(["+running=audioset", *TINY, "+model/loss=bce"])
    with pytest.raises(ValueError, match="num_labels"):
        losses.build_loss_head(port_cfg.model.loss, in_dim=D)


# ---------------------------------------------------------- the classifiers
STEPS = {
    "ESClassifier": (ESC, []),
    "ASClassifier_imagine": (AS, []),
    "ASClassifier_bce": (AS, ["+model/loss=bce"]),
}


def _step_over(data, which, tmp):
    base, extra = STEPS[which]
    over = [o for o in base if not (extra and o.startswith("+model/loss"))] + extra
    root = data["esc"] if which == "ESClassifier" else data["as"]
    return over + [f"running.data_root={root}", "running.data_name=" + (
        "esc50" if which == "ESClassifier" else "as_train"), "running.eval_name=" + (
        "" if which == "ESClassifier" else "as_train"), "eval=False", f"alias_root={tmp}",
        f"model_root={tmp}"]


@pytest.mark.parametrize("which", sorted(STEPS))
def test_classifier_step_matches_the_jax_step(data, tmp_path, which):
    over = _step_over(data, which, tmp_path)
    tr = build_monitor(over, device="cpu")
    assert isinstance(tr, ESCTrainer if which == "ESClassifier" else ASTrainer)
    jcfg = jax_compose(over)
    n_out = tr.output_dim
    jmodel = jax_build_model(jcfg, output_dim=n_out)
    params = _np(init_model(jcfg, jmodel, output_dim=n_out)["params"])
    from_jax.load_params(tr.model, params)
    r = np.random.default_rng(5)
    audio = r.standard_normal((4, 1, 100, 128)).astype(np.float32)
    if which == "ESClassifier":
        batch = (audio, r.integers(0, n_out, 4).astype(np.int32))
    else:
        image = r.standard_normal((4, 3, 224, 224)).astype(np.float32)
        batch = (image, audio, (r.random((4, n_out)) < 0.5).astype(np.float32))

    def jloss(p):
        out = jmodel.apply({"params": p}, *batch, train=True)
        return out if isinstance(out, tuple) else (out, {})

    (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    loss, aux, grads = loss_aux_and_grads(tr.state, *tr.make_batch(*batch))
    assert abs(loss.item() - float(jl)) <= STEP_RTOL * abs(float(jl))
    assert sorted(aux) == sorted(jaux) == (["bce", "ce"] if which.endswith("imagine") else [])
    for k in aux:
        assert abs(aux[k].item() - float(jaux[k])) <= STEP_RTOL * abs(float(jaux[k]))
    want = from_jax.model_state_dict(_np(jgrads))
    assert grads and set(grads) <= set(want)
    assert any(k.startswith("loss.") for k in grads) and any(k.startswith("audio.") for k in grads)
    for k, g in grads.items():
        w = want[k]
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(w).max()), err_msg=k)
    m = tr.train_step(*tr.make_batch(*batch))
    assert sorted(k for k in m if k.startswith("loss_")) == [f"loss_{k}" for k in sorted(aux)]


# ------------------------------------------------------------ the data layer
def _same(got, want, path="value"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


XFOLD = {
    "esc50": ("esc", []),
    "esc50_multi_prompt": ("esc", ["running.prompt=multi"]),
    "us8k": ("us8k", ["running.data_name=us8k"]),
    "jsonl": ("jsonl", ["running.data_name=clips"]),
    "audioset_eval": ("aseval", ["running.data_name=audioset", "running.prompt=the sound of"]),
    "voxceleb2": ("vox", ["running.data_name=voxceleb2", "running.nsample_per_vid=2"]),
}


def _xfold(data, name):
    root, extra = XFOLD[name]
    port_cfg, jax_cfg = _cfgs([*ESC, f"running.data_root={data[root]}", *extra])
    return (esc50.build_xfold_dataloader_list(port_cfg),
            jax_esc50.build_xfold_dataloader_list(jax_cfg))


def _records(loader):
    return None if loader is None else loader.dataset.records


@pytest.mark.parametrize("name", sorted(XFOLD))
def test_xfold_builders_give_the_jax_folds(data, name):
    (loaders, classes, ids, extras), (jloaders, jclasses, jids, jextras) = _xfold(data, name)
    assert len(loaders) == len(jloaders) >= 1
    for (tr, ev), (jtr, jev) in zip(loaders, jloaders):
        _same(_records(tr), _records(jtr))
        _same(_records(ev), _records(jev))
        assert (tr is None) == (name in ("audioset_eval", "voxceleb2", "jsonl"))
    assert classes == jclasses and ids.dtype == jids.dtype and np.array_equal(ids, jids)
    _same(extras, jextras)
    if name == "esc50_multi_prompt":
        assert ids.shape == (4 * len(CLASSES), 77)  # the first 4 prompts of each class
        assert extras["label_map"] == {i: i // 4 for i in range(12)}


@pytest.mark.parametrize("train", [True, False])
def test_audio_label_items_and_batches_are_the_jax_ones(data, train):
    (loaders, *_), (jloaders, *_) = _xfold(data, "esc50")
    tr, ev = loaders[0]
    jtr, jev = jloaders[0]
    ds, jds = (tr, jtr) if train else (ev, jev)
    ds, jds = ds.dataset, jds.dataset
    assert ds.transform_fbank and ds.train == train  # SpecAugment draws at train time
    items, jitems = [], []
    for i in range(len(ds)):
        np.random.seed(100 + i)
        items.append(ds[i])
        np.random.seed(100 + i)
        jitems.append(jds[i])
    _same(items, jitems)
    _same(esc50.AudioLabelCollator()(items), jax_esc50.AudioLabelCollator()(jitems))
    got, want = list(ev), list(jev)  # the eval loader pads its last batch
    _same(got, want)
    assert sum(b["_count"] for b in got) == len(ev.dataset)


def _defs(module, names):
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef)) and body
                and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name in names}


@pytest.mark.parametrize("port,orig,names", [
    (esc50, jax_esc50, ["AudioLabelDataset", "AudioLabelCollator", "MReserveDataset",
                        "MReserveCollator", "_prompted_label_texts", "build_esc50_folds",
                        "build_us8k_folds", "build_jsonl_eval_fold", "build_audioset_eval_fold",
                        "build_voxceleb2_eval_fold"]),
    (audioset, jax_audioset, ["build_filter_set", "label_map_token_matrix",
                              "build_audioset_label_map", "print_label_dist", "label_counts",
                              "sampling_weights"]),
], ids=["esc50", "audioset"])
def test_copied_definitions_are_the_same_code(port, orig, names):
    got, want = _defs(port, names), _defs(orig, names)
    assert sorted(got) == sorted(names)
    assert got == want


def test_mreserve_needs_its_package(data):
    (loaders, *_), _ = _xfold(data, "esc50")
    ds = esc50.MReserveDataset(loaders[0][1].dataset.cfg, loaders[0][1].dataset.records, False)
    with pytest.raises(ImportError, match="mreserve"):
        ds[0]


def _as_cfgs(data, *extra):
    return _cfgs([*AS, f"running.data_root={data['as']}", "running.data_name=as_train", *extra])


def test_audioset_label_map_and_tables_are_the_jax_ones(data):
    port_cfg, jax_cfg = _as_cfgs(data)
    lm = audioset.build_audioset_label_map(port_cfg.running)
    jlm = jax_audioset.build_audioset_label_map(jax_cfg.running)
    _same(lm, jlm)
    assert [v[1] for v in lm.values()] == ["the sound of dog", "the sound of rain"]  # ontology order
    assert np.array_equal(audioset.label_map_token_matrix(lm), jax_audioset.label_map_token_matrix(jlm))
    recs = jax_audioset.AudiosetSrc(jax_cfg.running, "as_train", True, jlm).records
    recs = recs + [{"id": "x", "labels": ["/m/dog", "/m/rain", "/m/unknown"]}]
    for fn in ("label_counts", "sampling_weights"):
        got, want = getattr(audioset, fn)(recs, lm, 2), getattr(jax_audioset, fn)(recs, jlm, 2)
        assert got.tobytes() == want.tobytes(), fn
    lines, jlines = [], []
    audioset.print_label_dist(lines.append, np.asarray([3.0, 120.0]), {0: "dog", 1: "a" * 20})
    jax_audioset.print_label_dist(jlines.append, np.asarray([3.0, 120.0]), {0: "dog", 1: "a" * 20})
    assert lines == jlines and "aaaaaaaaaaaaa.." in lines[0]


def test_filter_sets_in_their_three_formats(tmp_path):
    (tmp_path / "ids.csv").write_text("y1\ny3\n\n")
    (tmp_path / "per_label_2k").write_text(json.dumps({"/m/dog": ["y0", "y2"], "/m/rain": ["y5"]}))
    (tmp_path / "neighbours.jsonl").write_text(
        json.dumps({"y4": [["y6", 0.9], ["y7", 0.8], ["y1", 0.1]]}) + "\n\n"
        + json.dumps({"y9": [["y8", 0.5]]}) + "\n")
    for spec in ("ids.csv", "per_label_2k", "neighbours.jsonl,2", "missing.csv", "", None,
                 str(tmp_path / "ids.csv")):
        got = audioset.build_filter_set(spec, str(tmp_path))
        assert got == jax_audioset.build_filter_set(spec, str(tmp_path)), spec
    assert audioset.build_filter_set("neighbours.jsonl,2", str(tmp_path)) == {"y4", "y6", "y7", "y9", "y8"}


def test_weighted_sampling_draws_the_jax_loaders_indices(data):
    port_cfg, jax_cfg = _as_cfgs(data, "running.weighted_sampling=True", "running.mixup_rate=0.0")
    got = audioset.build_audioset_dataloader(port_cfg, "as_train", True)
    want = jax_audioset.build_audioset_dataloader(jax_cfg, "as_train", True)
    assert got.sample_weights is not None and not got.shuffle
    assert got.sample_weights.tobytes() == want.sample_weights.tobytes()
    orders = []
    for e in range(3):
        got.set_epoch(e)
        want.set_epoch(e)
        assert np.array_equal(got._order(), want._order()), e
        orders.append(got._order())
    assert not np.array_equal(orders[0], orders[1])  # each epoch its own draw
    assert len(set(orders[0].tolist())) < len(orders[0]) or len(orders[0]) <= 2  # with replacement


@pytest.mark.parametrize("mode", ["mixup", "contrastive", "eval"])
def test_audioset_items_and_batches_are_the_jax_ones(data, mode):
    extra = {"mixup": ["running.mixup_rate=1.0"], "contrastive": ["running.clf=False"],
             "eval": []}[mode]
    port_cfg, jax_cfg = _as_cfgs(data, *extra)
    train = mode != "eval"
    got = audioset.build_audioset_dataloader(port_cfg, "as_train", train).dataset
    want = jax_audioset.build_audioset_dataloader(jax_cfg, "as_train", train).dataset
    items, jitems = [], []
    for i in range(4):
        np.random.seed(200 + i)
        items.append(got[i])
        np.random.seed(200 + i)
        jitems.append(want[i])
    _same(items, jitems)
    if mode == "mixup":  # soft labels from the Beta(10, 10) draw
        assert any(((it["label"] > 0) & (it["label"] < 1)).any() for it in items)
    clf = mode != "contrastive"
    _same(audioset.AudiosetCollator(clf)(items), jax_audioset.AudiosetCollator(clf)(jitems))


def test_mixup_turns_on_device_off_with_a_warning(data):
    port_cfg, _ = _as_cfgs(data, "running.audio.on_device=True", "running.mixup_rate=0.5")
    with pytest.warns(UserWarning, match="mixup_rate > 0"):
        ds = audioset.build_audioset_dataloader(port_cfg, "as_train", True).dataset
    assert not ds.on_device
    port_cfg, _ = _as_cfgs(data, "running.audio.on_device=True", "running.mixup_rate=0.0")
    ds = audioset.build_audioset_dataloader(port_cfg, "as_train", True).dataset
    item = ds[0]
    assert ds.on_device and item["audio"].ndim == 1 and 0 < item["audio_len"] <= item["audio"].shape[0]
    batch = audioset.AudiosetCollator(True)([ds[0], ds[1]])
    assert batch["audio"].shape[0] == 2 and batch["audio_len"].dtype == np.int64


def test_a_packed_audioset_dataset_is_refused(data):
    """Packed AudioSet shards are classification only (tests/test_torch_packed.py
    holds the rest of the pak branch)."""
    port_cfg, jax_cfg = _as_cfgs(data, "running.clf=False")
    with pytest.raises(ValueError, match="clf=True only") as want:
        jax_audioset.build_audioset_dataloader(jax_cfg, "pak_train", True)
    with pytest.raises(ValueError) as got:
        audioset.build_audioset_dataloader(port_cfg, "pak_train", True)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------- the metrics
@pytest.mark.parametrize("seed", range(4))
def test_multilabel_report_is_the_jax_packages_without_sklearn(seed):
    """The port's NumPy AP / ROC AUC / precision-recall curve against the JAX
    package's report, which takes them from scikit-learn: tied scores, a
    class without positives and one without negatives, int and float labels."""
    from vipant_tpu.eval import metrics as jax_metrics
    from vipant_tpu_torch.eval import metrics

    r = np.random.default_rng(seed)
    n, c = 40 + 7 * seed, 6 + seed
    labels = (r.random((n, c)) < 0.3).astype(np.float32 if seed % 2 else np.int32)
    labels[:, 0], labels[:, 1] = 0, 1
    scores = np.round(r.random((n, c)), 1 + seed % 3).astype(np.float32)  # ties
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # scikit-learn's undefined-metric warnings
        want = jax_metrics.multilabel_report(scores, labels)
    got = metrics.multilabel_report(scores, labels)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])
    with pytest.raises(ValueError, match="0 / 1"):
        metrics.average_precision_score(labels * 0.5, scores)


# ------------------------------------------------------------------ monitors
@pytest.fixture(scope="module")
def esc_monitors(data, tmp_path_factory):
    """The JAX ESC monitor and the port's on its weights (zero-shot config),
    and the port's built for training."""
    run = str(tmp_path_factory.mktemp("escrun"))
    over = [*ESC, f"running.data_root={data['esc']}", "running.batch_size=2",
            f"alias_root={run}", f"model_root={run}", "running.zero_shot=True", "eval=True"]
    jmon = jax_build_monitor(jax_compose(over))
    mon = build_monitor(over, device="cpu")
    from_jax.load_params(mon.model, _np(jmon.state.full_params()))
    return jmon, mon


def test_esc_embeddings_match_the_jax_monitor(esc_monitors):
    jmon, mon = esc_monitors
    np.testing.assert_allclose(mon.encode_label_texts(), jmon.encode_label_texts(), rtol=0,
                               atol=HEAD_TOL)
    for (_, ev), (_, jev) in zip(mon.folds, jmon.folds):
        a, labels = mon._fold_apply(ev, "encode_audio")
        ja, jlabels = jmon._fold_audio_features(jev)
        assert a.shape == ja.shape and len(a) == len(ev.dataset)  # the padded batch trimmed
        np.testing.assert_allclose(a, ja, rtol=0, atol=HEAD_TOL)
        assert np.array_equal(labels, jlabels)


def test_esc_zero_shot_and_p1_match_the_jax_monitor(esc_monitors):
    jmon, mon = esc_monitors
    assert mon.standard_zero_shot() == jmon.standard_zero_shot()
    assert mon.learn() == jmon.learn()  # zero_shot=True: the pooled zero-shot
    for (_, ev), (_, jev) in zip(mon.folds, jmon.folds):
        assert mon.zero_shot(ev) == jmon.zero_shot(jev)
        assert mon.infer(ev) == jmon.infer(jev)
        preds, labels = mon._fold_predictions(ev)
        assert preds.dtype == np.int64 and len(preds) == len(ev.dataset)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_esc_summary_report_is_the_jax_monitors(esc_monitors):
    jmon, mon = esc_monitors
    trace = np.asarray([[50.0, 75.0, 70.0], [60.0, 65.0, 90.0]])
    lines = _Lines()
    mon.echo.addHandler(lines)
    try:
        got = mon.summary_report(trace)
    finally:
        mon.echo.removeHandler(lines)
    assert got == jmon.summary_report(trace) == 80.0  # the best common epoch: 2, (70 + 90) / 2
    text = "\n".join(lines.lines)
    assert "Total 3 epochs for each of 2 folds." in text
    assert "Best mean and std: 80.00 \\pm 10.00 in the 2th epoch." in text
    assert "Max mean and std: 82.50 \\pm 7.50 in the [1, 2]th epoch." in text


def test_esc_multi_prompt_zero_shot_collapses_as_the_jax_monitor(data, tmp_path):
    over = [*ESC, f"running.data_root={data['esc']}", "running.prompt=multi", "running.zero_shot=True",
            "eval=True", f"alias_root={tmp_path}", f"model_root={tmp_path}"]
    jmon = jax_build_monitor(jax_compose(over))
    mon = build_monitor(over, device="cpu")
    from_jax.load_params(mon.model, _np(jmon.state.full_params()))
    assert mon.zs_label_map == jmon.zs_label_map and len(mon.zs_label_map) == 12
    assert mon.standard_zero_shot() == jmon.standard_zero_shot()


@pytest.fixture(scope="module")
def as_monitors(data, tmp_path_factory):
    run = str(tmp_path_factory.mktemp("asrun"))
    over = [*AS, f"running.data_root={data['as']}", "running.eval_name=as_train", "eval=True",
            f"alias_root={run}", f"model_root={run}"]
    jmon = jax_build_monitor(jax_compose(over))
    mon = build_monitor(over, device="cpu")
    from_jax.load_params(mon.model, _np(jmon.state.full_params()))
    return jmon, mon


def test_as_reports_match_the_jax_monitor(as_monitors):
    jmon, mon = as_monitors
    assert mon.output_dim == jmon.output_dim == 2
    report = mon.infer(mon.evalloader)
    assert report == jmon.infer(jmon.evalloader)
    assert re.fullmatch(r"Mac-AP = \S+ Mic-AP = \S+ wAP = \S+ mAP = \S+ mAUC = \S+ mP = \S+ mR = \S+",
                        report)
    np.testing.assert_allclose(mon.encode_label_texts(), jmon.encode_label_texts(), rtol=0,
                               atol=HEAD_TOL)
    assert mon.zero_shot(mon.evalloader) == jmon.zero_shot(jmon.evalloader)


def test_as_audio_dump_matches_the_jax_monitor(as_monitors, tmp_path):
    jmon, mon = as_monitors
    got = np.load(mon.encode_audios_dump(mon.evalloader, str(tmp_path / "a.npz")))
    want = np.load(jmon.encode_audios_dump(jmon.evalloader, str(tmp_path / "j.npz")))
    assert list(got["names"]) == list(want["names"]) and len(got["names"]) == 8
    np.testing.assert_allclose(got["v"], want["v"], rtol=0, atol=HEAD_TOL)


def test_esc_supervised_beats_chance(data, tmp_path):
    """The x-fold protocol on tests/test_learning.py's two tone classes (250
    and 450 Hz, 6 clips each, 2 folds), a fresh model a fold: the mean P@1
    at the best common epoch must beat the 50 % of chance decisively (that
    test's bound, 85). SpecAugment off and 2 steps an epoch (B = 3) make 20
    epochs enough: 100.0 at seeds 1-5 and the default one (measured)."""
    over = [*ESC, f"running.data_root={data['tones']}", "running.zero_shot=False", "eval=False",
            "running.epochs=20", "running.batch_size=3", "model.loss.scaling=False",
            "running.audio.transform_fbank=False", f"alias_root={tmp_path}", f"model_root={tmp_path}"]
    mon = build_monitor(over, device="cpu")
    first = mon.model
    mean_p1 = mon.learn()
    assert mean_p1 >= 85.0, mean_p1
    # the last fold's fresh model and step count: 6 training clips, 2 steps an epoch
    assert mon.model is not first and mon.global_step == 20 * 2


# --------------------------------------------------------------- the engine
@pytest.mark.parametrize("worker", ["ESClassifier", "ASClassifier"])
def test_classifier_engines_serve_as_the_jax_engine(worker):
    """The JAX engine cannot build a classifier (its init calls the model's
    loss on a labelled batch: ``CELossHead`` takes no ``train``, the
    classifier heads no label count; ROADMAP.md queue C). The port's
    classifier engine holds the audio and text towers of a JAX CLAP engine
    (the same tower configs) and must serve what that engine serves."""
    over = ["+running=esc50", *TINY, "+model/loss=ce", "model_file=", "eval=True"]
    jeng = JaxEngine(over + ["worker=CLAP"], batch_size=4)
    eng = InferenceEngine(over + [f"worker={worker}"], batch_size=4, device="cpu")
    from_jax.load_params(eng.model, {k: v for k, v in _np(jeng.variables["params"]).items()
                                     if k in ("audio", "text", "loss")})
    fb = np.random.default_rng(9).standard_normal((6, 100, 128)).astype(np.float32)
    np.testing.assert_allclose(eng.embed_audio(fb), jeng.embed_audio(fb), rtol=0, atol=ENGINE_ATOL)
    texts = ["a dog", "rain", "a siren", "wind", "birds"]
    np.testing.assert_allclose(eng.embed_texts(texts, prompt="the sound of "),
                               jeng.embed_texts(texts, prompt="the sound of "), rtol=0, atol=ENGINE_ATOL)
    classes = {c: [f"the sound of {c}", f"a {c}"] for c in texts}
    got, want = eng.zero_shot(fb, classes), jeng.zero_shot(fb, classes)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=ENGINE_ATOL)
    assert got["prediction"] == want["prediction"]


def test_the_jax_engine_cannot_build_a_classifier():
    over = ["+running=esc50", *TINY, "+model/loss=ce", "model_file=", "eval=True", "worker=ESClassifier"]
    with pytest.raises(TypeError, match="train"):
        JaxEngine(over, batch_size=4)
