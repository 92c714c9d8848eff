"""The port's trimodal, siamese, Barlow and image-text paths against the JAX
package, on the CPU, at a small size (towers of width 64 / 32, 2 layers,
100 x 128 fbanks) in fp32:

- the heads (``VALCELossHead``, ``VACELossHead``, ``BarlowLossHead``,
  ``BarlowCELossHead``, built by both packages' ``build_loss_head`` from
  their YAML): the loss, its parts and the grads of every param and input
  within 1e-5 of their scale (tests/test_torch_classify.py's head bound,
  which holds the loss so; Barlow's grads reach ~15); Barlow's
  BatchNorm running statistics after 3 training calls, and its eval output,
  which changes none of them;
- the steps: ``CVALP`` (and with ``running.siamese.amodules=[encoder,misc]``
  over a frozen image tower), ``CVASP`` (its view tower tied whole) and
  ``CLVP`` through the monitors' train state against ``jax.value_and_grad``
  of the JAX model on the JAX trainer's pruned tree with ``restore_tied``:
  the loss within rtol 1e-5, its parts too, each trainable grad by name
  within rtol 1e-3 and atol 1e-3 * max |grad|, the tied sources holding the
  summed grad, the trainable set the JAX tie rule's; a tie whose shapes
  differ raises naming both stages; ``int8_frozen`` on a tower with a tied
  trainable stage raises; the weight export holds the tied stages under
  every tower;
- the conversions: ``from_jax`` loads a pruned and a full tree into a tied
  model alike, gives both trees back, and carries ``batch_stats`` both ways;
  a Barlow trainer's checkpoint resumes its running statistics bitwise;
- the views: ``FbankViews`` and the three image view transforms give the
  JAX package's outputs bitwise under one seed of ``random`` and
  ``np.random``; the siamese dataset's items (with a frame) and the
  image-text dataset's items and batches are bitwise the JAX package's;
- the monitors on the JAX weights: ``VALMonitor``'s report (VA, AL, the
  zero-shot P@1) and ``VASMonitor``'s pivot retrieval report equal the JAX
  monitors' strings; ``LAMonitor`` with ``running.dataloader=lv`` reports
  as the JAX one;
- the resumes: a siamese run resumed mid-epoch on process workers ends
  bitwise where the uninterrupted run ends (the port's workers reseed
  ``random``); the JAX loader's views differ after a resume;
- the JAX package's siamese item without a frame takes a random pivot from
  the global RNG; the port's takes zeros; the siamese ``on_device`` form
  ships the JAX package's waveform view and trains through the device
  frontend; CLIP's ``logit_scale`` seeds every pair head's temperature.
"""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import vipant_tpu.data.transforms_audio as jax_ta
import vipant_tpu.data.transforms_image as jax_ti
from vipant_tpu.config import compose as jax_compose
from vipant_tpu.data import image_audio as jax_image_audio
from vipant_tpu.data import image_text as jax_image_text
from vipant_tpu.data.loader import DataLoader as JaxLoader
from vipant_tpu.models import build_main_model as jax_build_model, init_model
from vipant_tpu.models.build import siamese_ties as jax_siamese_ties
from vipant_tpu.models.build import tunable_mask as jax_tunable_mask
from vipant_tpu.nn import losses as jax_losses
from vipant_tpu.nn.tying import prune_tied, restore_tied
from vipant_tpu.train import build_monitor as jax_build_monitor
import vipant_tpu_torch.data.transforms_audio as ta
import vipant_tpu_torch.data.transforms_image as ti
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.data import image_audio, image_text
from vipant_tpu_torch.nn import losses
from vipant_tpu_torch.nn.tying import tie_parameters
from vipant_tpu_torch.tokenizer import tokenize
from vipant_tpu_torch.train import (LATrainer, Trainer, VALTrainer, VASTrainer, build_monitor,
                                    loss_aux_and_grads)

from data_synth import make_synth_audioset, make_synth_va_index
from fbank_route import pin_numpy_fbank
from test_trainers import TINY_MODEL
from torch_dist_worker import one_rank

TINY = [*TINY_MODEL, "compute_dtype=float32"]
HEAD_TOL = 1e-5
STEP_RTOL = 1e-5
GRAD_RTOL = 1e-3
B, D = 6, 32


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


def _cfgs(over):
    return compose(over), jax_compose(over)


def _unit(r, *shape):
    x = r.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ------------------------------------------------------------------ heads
HEADS = {
    "VALCELossHead": (["+model/loss=ce_val", "model.loss.lv=True", "model.loss.al_w=0.5"], 3),
    "VACELossHead": (["+model/loss=ce_va", "model.loss.ap=True", "model.loss.aa=True",
                      "model.loss.vv_w=2.0"], 5),
    "BarlowLossHead": (["+model/loss=barlow", "model.loss.layers=[24,16,16]"], 2),
    "BarlowCELossHead": (["+model/loss=barlow_ce", "model.loss.barlow.layers=[24,16,16]"], 2),
}
PARTS = {"VALCELossHead": ["al", "lv", "va"], "VACELossHead": ["aa", "ap", "va", "vp", "vv"]}


def _head_inputs(n, seed=3):
    r = np.random.default_rng(seed)
    return tuple(_unit(r, B, D) for _ in range(n))


@pytest.fixture(scope="module", params=sorted(HEADS))
def heads(request):
    name = request.param
    extra, n = HEADS[name]
    port_cfg, jax_cfg = _cfgs(["+running=bimodal", *TINY, *extra])
    assert port_cfg.model.loss.name == name
    jhead = jax_losses.build_loss_head(jax_cfg.model.loss)
    head = losses.build_loss_head(port_cfg.model.loss)
    args = _head_inputs(n)
    variables = _np(jhead.init(jax.random.PRNGKey(1), *args))
    sd = {k: torch.tensor(v) for k, v in from_jax.loss_state_dict(variables["params"]).items()}
    if "batch_stats" in variables:
        sd.update({k: torch.tensor(v)
                   for k, v in from_jax.batch_stats_state_dict(variables["batch_stats"]).items()})
    head.load_state_dict(sd, strict=True)
    return name, jhead, head, variables, args


def _grad_tol(w):
    """HEAD_TOL on the scale of the grad, as the loss is held: Barlow's grads
    reach ~15, and both packages' fp32 grads lie 1e-5 to 3e-5 from a float64
    run there (measured)."""
    return HEAD_TOL * max(1.0, float(np.abs(w).max()))


def _jax_out(out):
    return out if isinstance(out, tuple) else (out, {})


def test_heads_build_with_the_jax_names(heads):
    name, _, head, variables, _ = heads
    assert type(head).__name__ == name
    params = variables["params"]
    assert sorted(dict(head.named_parameters())) == sorted(from_jax.loss_state_dict(params))
    stats = variables.get("batch_stats", {})
    assert sorted(dict(head.named_buffers())) == sorted(from_jax.batch_stats_state_dict(stats))
    assert ("barlow" in name.lower()) == bool(stats)
    back = from_jax.to_jax_params({f"loss.{k}": p for k, p in head.named_parameters()})["loss"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)


def test_head_loss_parts_and_grads_match_the_jax_head(heads):
    name, jhead, head, variables, args = heads

    def jloss(p, *x):
        out = jhead.apply({**variables, "params": p}, *x, mutable=["batch_stats"])[0] \
            if "batch_stats" in variables else jhead.apply({"params": p}, *x)
        return _jax_out(out)

    (jl, jaux), grads = jax.value_and_grad(jloss, argnums=tuple(range(len(args) + 1)),
                                           has_aux=True)(variables["params"], *args)
    xs = [torch.tensor(a, requires_grad=True) for a in args]
    loss, aux = (lambda o: o if isinstance(o, tuple) else (o, {}))(head(*xs))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= HEAD_TOL * max(1.0, abs(float(jl)))
    assert sorted(aux) == sorted(jaux) == PARTS.get(name, [])
    for k in aux:
        assert abs(aux[k].item() - float(jaux[k])) <= HEAD_TOL * max(1.0, abs(float(jaux[k])))
    for x, g in zip(xs, grads[1:]):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0, atol=_grad_tol(g))
    want = from_jax.loss_state_dict(_np(grads[0]))
    got = {k: p.grad for k, p in head.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0, atol=_grad_tol(want[k]), err_msg=k)


@pytest.mark.parametrize("name", ["BarlowLossHead", "BarlowCELossHead"])
def test_barlow_statistics_after_three_steps_and_its_eval(name):
    extra, n = HEADS[name]
    port_cfg, jax_cfg = _cfgs(["+running=bimodal", *TINY, *extra])
    jhead = jax_losses.build_loss_head(jax_cfg.model.loss)
    head = losses.build_loss_head(port_cfg.model.loss)
    variables = _np(jhead.init(jax.random.PRNGKey(2), *_head_inputs(n)))
    head.load_state_dict({**{k: torch.tensor(v) for k, v in from_jax.loss_state_dict(
        variables["params"]).items()}, **{k: torch.tensor(v) for k, v in from_jax.batch_stats_state_dict(
            variables["batch_stats"]).items()}})
    stats = variables["batch_stats"]
    for step in range(3):
        x = _head_inputs(n, seed=10 + step)
        _, mut = jhead.apply({"params": variables["params"], "batch_stats": stats}, *x,
                             mutable=["batch_stats"])
        stats = _np(mut["batch_stats"])
        head(*(torch.tensor(a) for a in x))
    want = from_jax.batch_stats_state_dict(stats)
    got = dict(head.named_buffers())
    init = from_jax.batch_stats_state_dict(variables["batch_stats"])
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-6, err_msg=k)
        assert not np.array_equal(w, init[k]), k  # the statistics moved
    x = _head_inputs(n, seed=20)
    want = jhead.apply({"params": variables["params"], "batch_stats": stats}, *x, train=False)
    before = {k: b.clone() for k, b in got.items()}
    with torch.no_grad():
        out = head(*(torch.tensor(a) for a in x), train=False)
    assert abs(out.item() - float(want)) <= HEAD_TOL * max(1.0, abs(float(want)))
    assert all(torch.equal(before[k], b) for k, b in head.named_buffers())


def test_batchnorm_is_flax_not_torch():
    """Biased running variance and momentum 0.99, where torch's BatchNorm1d
    keeps the unbiased one and moves by 0.1."""
    bn = losses.BatchNorm(3)
    x = torch.tensor([[1.0, 2.0, 0.0], [3.0, 2.0, 1.0]])
    bn(x)
    np.testing.assert_allclose(bn.mean.numpy(), 0.01 * x.mean(0).numpy(), atol=1e-7)
    np.testing.assert_allclose(bn.var.numpy(), 0.99 + 0.01 * x.var(0, unbiased=False).numpy(), atol=1e-7)


# ------------------------------------------------------------------ steps
STEPS = {
    "CVALP": ["+running=trimodal", *TINY, "+model/loss=ce_val", "worker=CVALP", "monitor=VALMonitor",
              "model.loss.lv=True", "running.label_map=", "model.image.freeze=False"],
    "CVALP_tied": ["+running=trimodal", *TINY, "+model/loss=ce_val", "worker=CVALP",
                   "monitor=VALMonitor", "model.loss.lv=True", "running.label_map=",
                   "running.siamese.alive=True", "running.siamese.amodules=[encoder,misc]"],
    "CVASP": ["+running=siamese", *TINY, "+model/loss=ce_va", "worker=CVASP", "monitor=VASMonitor",
              "model.loss.aa=True", "model.loss.ap=True", "model.image.freeze=False"],
    "CLVP": ["+running=audiocaps", *TINY, "+model/loss=ce", "worker=CLVP", "monitor=LAMonitor",
             "running.dataloader=lv", "model.image.freeze=False"],
}


def _grid(cfg):
    n = int(cfg.model.image.resolution) // int(cfg.model.image.pre_encoder.patch_size)
    return (n, n)


def _jax_model(jcfg):
    """The JAX model, its audio tower storing its positional embedding at the
    image grid when ``misc`` is tied (``misc_stored_grid``, which the JAX
    builders never set: its misc tie fails at the first apply otherwise)."""
    m = jax_build_model(jcfg)
    if ("audio/misc", "image/misc") in jax_siamese_ties(jcfg):
        m = m.clone(audio=m.audio.clone(misc_stored_grid=_grid(jcfg)))
    return m


def _batch(which, r):
    image = lambda: r.standard_normal((4, 3, 224, 224)).astype(np.float32)
    audio = lambda: r.standard_normal((4, 1, 100, 128)).astype(np.float32)
    text = tokenize(["a dog barks", "rain on a roof", "a car horn in traffic", "birds"])
    if which.startswith("CVALP"):
        return (image(), audio(), text)
    if which == "CVASP":
        return (image(), image(), audio(), image(), audio())
    return (image(), text)


@pytest.fixture(scope="module", params=sorted(STEPS))
def steps(request, tmp_path_factory):
    which = request.param
    run = str(tmp_path_factory.mktemp(which))
    over = STEPS[which] + [f"alias_root={run}", f"model_root={run}", "model_file="]
    tr = build_monitor(one_rank(over), device="cpu", steps_per_epoch=10)
    jcfg = jax_compose(over)
    jmodel = _jax_model(jcfg)
    ties = jax_siamese_ties(jcfg)
    params = _np(prune_tied(init_model(jcfg, jmodel)["params"], ties))
    from_jax.load_params(tr.model, params)
    return which, tr, jcfg, jmodel, ties, params


def test_monitor_and_ties_are_the_jax_packages(steps):
    which, tr, jcfg, _, ties, params = steps
    assert type(tr) is {"CVALP": VALTrainer, "CVALP_tied": VALTrainer, "CVASP": VASTrainer,
                        "CLVP": LATrainer}[which]
    assert [tuple(t) for t in tr.ties] == [tuple(t) for t in ties]
    for dst, src in ties:  # every tied pair is one storage
        d, s = (tr.model.get_submodule(p.replace("/", ".")) for p in (dst, src))
        for (n1, p1), (n2, p2) in zip(d.named_parameters(), s.named_parameters()):
            assert n1 == n2 and p1 is p2
    mask = from_jax.model_state_dict(jax_tunable_mask(jcfg, params, ties), convert=False)
    assert sorted(tr.trainable) == sorted(k for k, v in mask.items() if v)
    assert set(tr.frozen) == {k for k, v in mask.items() if not v}
    if which == "CVALP_tied":  # the frozen image tower's tied stages train (the JAX tie rule)
        assert any(k.startswith("image.encoder.") for k in tr.trainable)
        assert any(k.startswith("image.misc.") for k in tr.trainable)
        assert all(not k.startswith("image.pre_encoder.") for k in tr.trainable)
        assert not any(k.startswith(("audio.encoder.", "audio.misc.")) for k in tr.trainable)


def test_step_matches_the_jax_step(steps):
    which, tr, _, jmodel, ties, params = steps
    batch = _batch(which, np.random.default_rng(5))

    def jloss(p):
        out = jmodel.apply({"params": restore_tied(p, ties)}, *batch, train=True)
        return _jax_out(out)

    (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    loss, aux, grads = loss_aux_and_grads(tr.state, *tr.make_batch(*batch))
    assert abs(loss.item() - float(jl)) <= STEP_RTOL * abs(float(jl))
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        assert abs(aux[k].item() - float(jaux[k])) <= STEP_RTOL * abs(float(jaux[k])), k
    want = from_jax.model_state_dict(_np(jgrads))
    assert grads and set(grads) <= set(want)
    for k, g in grads.items():
        w = want[k]
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(w).max()), err_msg=k)
    if ties:  # the sources hold both towers' grads
        src = ties[-1][1].replace("/", ".") + "."
        assert any(k.startswith(src) and np.abs(w).max() > 0 for k, w in want.items() if k in grads)
    m = tr.train_step(*tr.make_batch(*batch))
    assert sorted(k for k in m if k.startswith("loss_")) == [f"loss_{k}" for k in sorted(aux)]


def test_the_export_restores_the_tied_stages(steps):
    which, tr, _, _, ties, params = steps
    export = tr.collect_model_export()
    towers = {k.split(".", 1)[0] for k in export}
    assert towers == {"CVALP": {"image", "audio", "text", "loss"},
                      "CVALP_tied": {"image", "audio", "text", "loss"},
                      "CVASP": {"audio", "loss"}, "CLVP": {"loss"}}[which]
    if which == "CVALP_tied":
        for k in export:
            if k.startswith("audio.encoder."):
                assert export[k] is export["image" + k[len("audio"):]]
        full = from_jax.to_jax_params(export)
        np.testing.assert_array_equal(full["audio"]["misc"]["positional_embedding"],
                                      full["image"]["misc"]["positional_embedding"])
        assert full["audio"]["misc"]["positional_embedding"].shape[0] == 50  # the image grid


def test_a_tie_whose_shapes_differ_raises(tmp_path):
    tr = build_monitor(one_rank(STEPS["CVALP"] + [f"alias_root={tmp_path}", f"model_root={tmp_path}"]),
                                device="cpu", steps_per_epoch=1)
    with pytest.raises(ValueError, match=r"text/misc.*image/misc|image/misc.*text/misc"):
        tie_parameters(tr.model, [("text/misc", "image/misc")])
    with pytest.raises(ValueError, match="text/encoder/.*image/encoder/"):
        tie_parameters(tr.model, [("text/encoder", "image/encoder")])


def test_int8_frozen_on_a_tower_with_a_trained_tie_raises(tmp_path):
    over = STEPS["CVALP_tied"] + [f"alias_root={tmp_path}", f"model_root={tmp_path}",
                                  "model.image.int8_frozen=True"]
    with pytest.raises(ValueError, match="int8_frozen"):
        build_monitor(one_rank(over), device="cpu", steps_per_epoch=1)


# ------------------------------------------------------------ conversions
@pytest.mark.parametrize("which", ["CVALP_tied", "CVASP"])
def test_tied_models_take_and_give_pruned_and_full_trees(tmp_path, which):
    over = STEPS[which] + [f"alias_root={tmp_path}", f"model_root={tmp_path}"]
    jcfg = jax_compose(over)
    jmodel = _jax_model(jcfg)
    ties = jax_siamese_ties(jcfg)
    full = _np(init_model(jcfg, jmodel)["params"])
    pruned = prune_tied(full, ties)
    a = build_monitor(one_rank(over), device="cpu", steps_per_epoch=1)
    b = build_monitor(one_rank(over), device="cpu", steps_per_epoch=1)
    from_jax.load_params(a.model, pruned)
    from_jax.load_params(b.model, restore_tied(pruned, ties))  # a full tree: the sources win
    for (k, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), k
    for tree, want in ((from_jax.jax_params_of(a.model, pruned=True), pruned),
                       (from_jax.jax_params_of(a.model), restore_tied(pruned, ties))):
        flat_got, flat_want = from_jax.flatten(tree), from_jax.flatten(want)
        assert sorted(flat_got) == sorted(flat_want)
        for k, v in flat_want.items():
            np.testing.assert_array_equal(flat_got[k], v, err_msg=k)


def test_batch_stats_convert_both_ways():
    port_cfg, jax_cfg = _cfgs(["+running=bimodal", *TINY, *HEADS["BarlowCELossHead"][0]])
    jhead = jax_losses.build_loss_head(jax_cfg.model.loss)
    variables = _np(jhead.init(jax.random.PRNGKey(4), *_head_inputs(2)))
    stats = jax.tree_util.tree_map(lambda v: v + np.arange(v.size, dtype=np.float32).reshape(v.shape),
                                   variables["batch_stats"])
    model = torch.nn.Module()
    model.loss = losses.build_loss_head(port_cfg.model.loss)
    from_jax.load_batch_stats(model, {"loss": stats})
    back = from_jax.to_jax_batch_stats(dict(model.named_buffers()))
    assert from_jax.flatten(back).keys() == from_jax.flatten({"loss": stats}).keys()
    for k, v in from_jax.flatten({"loss": stats}).items():
        np.testing.assert_array_equal(from_jax.flatten(back)[k], v)
    with pytest.raises(ValueError, match="buffers"):
        from_jax.load_batch_stats(model, {"loss": {"barlow": {}}})


# ------------------------------------------------------------------ views
def test_fbank_views_are_the_jax_packages():
    fb = np.random.default_rng(0).standard_normal((400, 128)).astype(np.float32) * 3 - 5
    for both in (True, False):
        for train in (True, False):
            np.random.seed(9)
            got = ta.FbankViews()(fb, both=both, train=train)
            np.random.seed(9)
            want = jax_ta.FbankViews()(fb, both=both, train=train)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert ta.VIEW_SENTINEL.tobytes() == jax_ta.VIEW_SENTINEL.tobytes()
    assert (ta.AUDIOSET_FBANK_MEAN, ta.AUDIOSET_FBANK_STD) == (jax_ta.AUDIOSET_FBANK_MEAN,
                                                               jax_ta.AUDIOSET_FBANK_STD)


@pytest.mark.parametrize("kind", ["shared", "authentic", "train"])
def test_image_view_transforms_are_the_jax_packages(kind):
    img = Image.fromarray((np.random.default_rng(1).random((80, 120, 3)) * 255).astype(np.uint8))
    for seed in range(6):
        outs = []
        for mod in (ti, jax_ti):
            random.seed(seed)
            np.random.seed(seed)
            if kind == "train":
                outs.append((mod.TrainImageTransform(64)(img),))
            else:
                cls = mod.SharedImageTransform if kind == "shared" else mod.AuthenticImageViews
                outs.append(cls(64)(img, both=seed % 2 == 0, train=seed % 3 != 0))
        for g, w in zip(*outs):
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), seed


@pytest.fixture(scope="module")
def va(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("va"))
    make_synth_va_index(d, "train", n=8, seconds=1.05)
    with open(os.path.join(d, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(d, "noframe.jsonl"), "w") as f:
        f.writelines(json.dumps({k: v for k, v in r.items() if k != "frame"}) + "\n" for r in recs[:2])
    return d


SIAMESE = ["+running=siamese", *TINY, "+model/loss=ce_va", "worker=CVASP", "monitor=VASMonitor",
           "running.batch_size=4", "num_proc=2"]


def _siamese(root, name, train, *extra):
    port_cfg, jax_cfg = _cfgs(SIAMESE + [f"running.data_root={root}", *extra])
    flags = lambda cfg: {k: cfg.model.loss[k] for k in ("vv", "aa")}
    return (image_audio.ImageAudioDatasetSiameseSrc(port_cfg.running, name, train, flags(port_cfg)),
            jax_image_audio.ImageAudioDatasetSiameseSrc(jax_cfg.running, name, train, flags(jax_cfg)))


def _same_item(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), (what, k)
        else:
            assert g == w, (what, k)


@pytest.mark.parametrize("extra", [[], ["model.loss.aa=True"], ["model.loss.vv=False"],
                                   ["running.clip_tf=True", "model.loss.aa=True"],
                                   ["running.image_uint8=True"]],
                         ids=["vv", "vv_aa", "none", "clip_tf", "uint8"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_siamese_items_are_the_jax_packages(va, train, extra):
    port, jds = _siamese(va, "train", train, *extra)
    for i in range(3):
        items = []
        for ds in (port, jds):
            random.seed(50 + i)
            np.random.seed(50 + i)
            items.append(ds[i])
        _same_item(*items, f"item {i}")
    coll = [image_audio.ImageAudioCollator(True), jax_image_audio.ImageAudioCollator(True)]
    random.seed(0)
    np.random.seed(0)
    got = coll[0]([port[0], port[1]])
    random.seed(0)
    np.random.seed(0)
    _same_item(got, coll[1]([jds[0], jds[1]]), "batch")


def test_a_siamese_record_without_a_frame(va):
    """The JAX package's item opens ``None`` and takes a random image from the
    global RNG as its pivot (``vipant_tpu/data/image_audio.py:351``); the
    port gives zeros, as the single-view item does."""
    port, jds = _siamese(va, "noframe", True)
    np.random.seed(3)
    with pytest.warns(UserWarning, match="random image"):
        want = jds[0]
    np.random.seed(3)
    noise = jax_ti.clip_preprocess(
        Image.fromarray((np.random.rand(224, 224, 3) * 256).astype(np.uint8)), 224)
    assert want["image"].tobytes() == noise.tobytes() and np.abs(want["image"]).max() > 0
    got = port[0]
    assert got["image"].shape == (3, 224, 224) and not got["image"].any()
    assert got["image_v1"].shape == (3, 224, 224) and not got["image_v1"].any()
    assert not got["image_v2"].any() and got["audio_v1"].shape == want["audio_v1"].shape


@pytest.fixture(scope="module")
def it_root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("it"))
    os.makedirs(os.path.join(d, "frames", "frame"))
    r = np.random.default_rng(0)
    with open(os.path.join(d, "frames.jsonl"), "w") as f:
        for i in range(5):
            Image.fromarray((r.random((64, 64, 3)) * 255).astype(np.uint8)).save(
                os.path.join(d, "frames", "frame", f"v{i}.0.jpg"))
            caps = [f"scene number {i} take {j}" for j in range(1 + i % 3)]
            f.write(json.dumps({"id": f"v{i}", "dir": "frames", "frame": "0.jpg", "captions": caps}) + "\n")
    return d


CLVP = [*STEPS["CLVP"], "running.batch_size=2"]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_image_text_items_and_batches_are_the_jax_packages(it_root, train):
    port_cfg, jax_cfg = _cfgs(CLVP + [f"running.data_root={it_root}", "num_proc=1"])
    loader = image_text.build_image_text_dataloader(port_cfg, "frames", train)
    jloader = jax_image_text.build_image_text_dataloader(jax_cfg, "frames", train)
    for i in range(len(loader.dataset)):
        np.random.seed(i)
        got = loader.dataset[i]
        np.random.seed(i)
        _same_item(got, jloader.dataset[i], f"item {i}")
    np.random.seed(1)
    got = list(loader)
    np.random.seed(1)
    want = list(jloader)
    assert len(got) == len(want) == (2 if train else 3)
    for g, w in zip(got, want):
        _same_item(g, w, "batch")


# --------------------------------------------------------------- monitors
@pytest.fixture(scope="module")
def as_root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("as"))
    make_synth_audioset(d, "as_train", n=8, seconds=1.05)
    return d


def _monitor_pair(over):
    jmon = jax_build_monitor(jax_compose(over))
    tr = build_monitor(one_rank(over), device="cpu")
    from_jax.load_params(tr.model, _np(jmon.state.full_params()))
    return jmon, tr


def test_val_monitor_report_is_the_jax_monitors(as_root, tmp_path):
    over = [*STEPS["CVALP"][:-2], "running.label_map=ontology,eval_segments",
            f"running.data_root={as_root}", "running.eval_name=as_train", "running.zero_shot=True",
            "running.batch_size=4", "running.eval_samples=8", "eval=True", "num_proc=1",
            f"alias_root={tmp_path}", f"model_root={tmp_path}", "model_file="]
    jmon, tr = _monitor_pair(over)
    got, want = tr.infer(tr.evalloader), jmon.infer(jmon.evalloader)
    assert got == want and "VA:" in got and "AL:" in got and "A->T: p1" in got
    assert tr.zero_shot(tr.evalloader) == jmon.zero_shot(jmon.evalloader)


def test_vas_monitor_report_is_the_jax_monitors(va, tmp_path):
    over = [*SIAMESE, f"running.data_root={va}", "running.eval_name=train", "running.eval_samples=8",
            "eval=True", "num_proc=1", f"alias_root={tmp_path}", f"model_root={tmp_path}", "model_file="]
    jmon, tr = _monitor_pair(over)
    got, want = tr.infer(tr.evalloader), jmon.infer(jmon.evalloader)
    assert got == want and got.startswith("I->A: t1 = ")


def test_lv_monitor_report_is_the_jax_monitors(it_root, tmp_path):
    over = [*CLVP, f"running.data_root={it_root}", "running.eval_name=frames", "running.test_name=",
            "eval=True", "num_proc=1", f"alias_root={tmp_path}", f"model_root={tmp_path}", "model_file="]
    jmon, tr = _monitor_pair(over)
    assert tr.batch_keys == ("image", "text")
    got, want = tr.infer(tr.evalloader), jmon.infer(jmon.evalloader)
    assert got == want and got.startswith("A->T: t1 = ")


# ---------------------------------------------------------------- resumes
def _vas_run(va, run, *extra):
    return build_monitor(one_rank([*SIAMESE, f"running.data_root={va}", "running.data_name=train",
                                   "running.eval_name=", "running.epochs=2", "running.peep_rate=1",
                                   "running.save_epoch=False", "loader_backend=process", "model.loss.aa=True",
                                   f"alias_root={run}", f"model_root={run}", "model_name=run", "eval=False",
                                   *extra]), device="cpu")


def _state(tr):
    sd = tr.state.state_dict()
    return sd["step"], sd["params"], sd["opt_state"], sd["rng"]


def _bitwise(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _bitwise(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _bitwise(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def test_a_siamese_resume_on_process_workers_is_bitwise(va, tmp_path):
    a = _vas_run(va, str(tmp_path / "a"), "running.save_rate=1000000", "model_file=")
    a.learn()
    b1 = _vas_run(va, str(tmp_path / "b"), "running.save_rate=3", "model_file=")
    b1.learn()
    b2 = _vas_run(va, str(tmp_path / "b"), "running.save_rate=1000000", "model_file=00000003")
    assert b2.global_step == 3
    b2.learn()
    assert a.global_step == b2.global_step == 4
    _bitwise(_state(b2), _state(a))


def test_the_jax_loaders_views_differ_after_a_resume(va):
    """The JAX loader seeds NumPy alone for each item; the image views draw
    from ``random``, so a resumed epoch's views are not the uninterrupted
    run's. The port's workers seed ``random`` too."""
    port_ds, jds = _siamese(va, "train", True)

    def tail(ds, cls, resumed):
        loader = cls(ds, batch_size=4, collate_fn=image_audio.ImageAudioCollator(True), shuffle=True,
                     drop_last=True, num_workers=2, backend="process", seed=1)
        try:
            loader.set_epoch(0, start_batch=1 if resumed else 0)
            return list(loader)[-1]
        finally:
            loader.shutdown()

    from vipant_tpu_torch.data.loader import DataLoader

    jax_whole, jax_resumed = tail(jds, JaxLoader, False), tail(jds, JaxLoader, True)
    assert jax_whole["name"] == jax_resumed["name"]
    assert jax_whole["image_v1"].tobytes() != jax_resumed["image_v1"].tobytes()
    whole, resumed = tail(port_ds, DataLoader, False), tail(port_ds, DataLoader, True)
    _same_item(resumed, whole, "port")


# ---------------------------------------------------------- Barlow trainer
def test_a_barlow_trainer_resumes_its_statistics_bitwise(va, tmp_path):
    def run(path, *extra):
        return Trainer(one_rank(["+running=bimodal", *TINY, "+model/loss=barlow_ce",
                                 "model.loss.barlow.layers=[24,16,16]", f"running.data_root={va}",
                                 "running.data_name=train", "running.eval_name=", "running.batch_size=4",
                                 "running.epochs=2", "running.peep_rate=1", "running.save_epoch=False",
                                 "loader_backend=process", "num_proc=2", f"alias_root={path}",
                                 f"model_root={path}", "model_name=run", "eval=False", *extra]), device="cpu")

    a = run(tmp_path / "a", "running.save_rate=1000000", "model_file=")
    init = {k: b.clone() for k, b in a.state.buffers.items()}
    assert sorted(init) == ["loss.barlow.bn_0.mean", "loss.barlow.bn_0.var", "loss.barlow.bn_1.mean",
                            "loss.barlow.bn_1.var"]
    a.learn()
    assert all(not torch.equal(init[k], b) for k, b in a.state.buffers.items())
    b1 = run(tmp_path / "b", "running.save_rate=3", "model_file=")
    b1.learn()
    step = os.path.join(str(tmp_path / "b"), "run", "00000003")
    assert "batch_stats.npz" in os.listdir(step)
    stats = from_jax.flatten(from_jax.to_jax_batch_stats(b1.state.buffers))
    assert sorted(np.load(os.path.join(step, "batch_stats.npz")).files) == sorted(stats)
    b2 = run(tmp_path / "b", "running.save_rate=1000000", "model_file=00000003")
    b2.learn()
    _bitwise(_state(b2), _state(a))
    for k, v in a.state.buffers.items():
        assert torch.equal(v, b2.state.buffers[k]), k


def test_the_siamese_on_device_form_ships_waveforms_and_trains(va, tmp_path):
    """``running.audio.on_device``: view 1 is the cropped waveform (the JAX
    package's, bitwise, under one seed), view 2 the sentinel unless ``aa``
    is on, each item with its true length; a training step takes them
    through the device frontend."""
    extra = ["running.audio.on_device=True", "running.audio.norms=[-4.93839311,5.75751113]"]
    port, jds = _siamese(va, "train", True, *extra)
    for i in range(2):
        items = []
        for ds in (port, jds):
            random.seed(i)
            np.random.seed(i)
            items.append(ds[i])
        got, want = items
        assert got["audio_v1"].tobytes() == want["audio_v1"].tobytes()
        assert got["audio_v2"].shape == (1, 1, 1) and 0 < got["audio_len"] <= got["audio_v1"].shape[0]
    tr = build_monitor(one_rank([*SIAMESE, *extra, f"running.data_root={va}", "running.data_name=train",
                                 "running.eval_name=", "model.loss.aa=True", f"alias_root={tmp_path}",
                                 f"model_root={tmp_path}", "model_file=", "eval=False", "num_proc=1"]),
                                device="cpu")
    batch = next(iter(tr.loader))
    assert batch["audio_v1"].ndim == 2 and batch["audio_v2"].ndim == 2 and "audio_len" in batch
    m = tr.train_step(*tr.device_put.wait(batch), audio_len=batch["audio_len"])
    assert np.isfinite(float(m["loss"])) and "loss_aa" in m
    tr.close()


def test_clip_logit_scale_reaches_every_pair_head(tmp_path):
    """CLIP's ``logit_scale`` seeds each pair's own temperature (``ce_va``,
    ``ce_lv``, ``ce_al``), as the JAX package's ``_copy_logit_scales``
    reaches every nested ``logit_scale``."""
    from vipant_tpu_torch.ckpt.loading import copy_logit_scales

    tr = build_monitor(one_rank(STEPS["CVALP"] + [f"alias_root={tmp_path}", f"model_root={tmp_path}"]),
                                device="cpu", steps_per_epoch=1)
    copy_logit_scales(tr.model, torch.tensor(4.25))
    scales = {k: p.item() for k, p in tr.model.named_parameters() if k.endswith("logit_scale")}
    assert sorted(scales) == ["loss.ce_al.logit_scale", "loss.ce_lv.logit_scale",
                              "loss.ce_va.logit_scale"]
    assert set(scales.values()) == {4.25}
