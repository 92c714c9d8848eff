"""The port's audio-text trainer (vipant_tpu_torch/train/monitors.py,
``LATrainer``; vipant_tpu_torch/data/audio_text.py) against the JAX
package's ``LATrainer`` (``LAMonitor``) on the tiny config ``TINY_MODEL`` of
tests/test_trainers.py in fp32 and the synthetic Clotho index of
tests/data_synth.py, on the CPU:

- the retrieval loop, with the text tower frozen and trained: both trainers
  from one init (the JAX params carried over by ``ckpt/from_jax.load_params``),
  four steps over two epochs at B = 2 (the thread backend, one worker, both
  packages on their NumPy fbank, np.random seeded alike before each
  ``learn``): each step's loss within rtol 1e-4, the final trainable params
  within atol 1e-5 under the Adam near-zero rule of
  tests/test_torch_trainer_loop.py (an element whose grad at some step is
  below 1e-3 of its tensor's rms, and not exactly zero, takes steps drawn
  from rounding noise and is left out), the save-time and ``TEST`` 1-vs-k metrics within 1e-6;
  ``repeated_retrieval`` over the run's ``train_0.out`` gives one report per
  saved step, each equal to the report the run logged after that save; the
  text embeddings of ``encode_text`` and ``encode_text_dump`` within atol 1e-5
  of the JAX ones;
- the captioning loop: the LM losses within rtol 1e-4; in ``caption_report``
  the decoded ids equal wherever the JAX decoder's top-2 logit margin exceeds
  1e-3, and the score line equal when the ids are;
- the CE gate: a bound below the loss skips the save-time eval and logs it,
  an infinite bound always evaluates, the default bound is 5;
- the datasets: Clotho CSV and AudioCaps JSONL records, items and collated
  batches bitwise the JAX ones (the prompt, a truncated caption that keeps
  its EOT, the cyclic pad of a clip with fewer captions, the warning for a
  clip with none, ``np_rnd`` under one seed);
- the refusals: ``running.dataloader=lv``, a ``pak*`` dataset and
  ``async_ckpt`` are ported (the monitor reaches their loaders: a missing
  index or pack raises ``FileNotFoundError``); the gradient cache (A15) is
  refused.
"""

import json
import os
import re
import warnings

import jax
import numpy as np
import pytest
import torch

import vipant_tpu.data.audio_text as jax_audio_text
import vipant_tpu.train.monitors as jax_monitors
from vipant_tpu.config import compose as jax_compose
from vipant_tpu.train import build_monitor as jax_build_monitor
import vipant_tpu_torch.data.audio_text as audio_text
import vipant_tpu_torch.train.monitors as monitors
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.train import LATrainer, build_monitor

from data_synth import _tone_wav, make_synth_clotho
from fbank_route import pin_numpy_fbank
from test_trainers import TINY_MODEL

ADAM_NEAR_ZERO = 1e-3  # tests/test_torch_trainer_loop.py's rule
MARGIN = 1e-3  # decoded ids must agree where the JAX decoder's top-2 logits are further apart
CAPTION = ["+model/text=transformer_decoder", "+model/loss=ce_lm", "model.text.width=32",
           "model.text.heads=4", "model.text.layers=2", "model.text.mem_width=64",
           "model.text.max_len_dec=8", "model.text.embed_dim=32", "running.retrieval=False"]
LONG = " ".join(["a very long caption"] * 30)  # > 77 tokens: truncated, its EOT kept


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_csv(root, name, rows):
    with open(os.path.join(root, f"{name}.csv"), "w") as f:
        f.write("file_name," + ",".join(f"caption_{i}" for i in range(1, 6)) + "\n")
        f.writelines(",".join(r) + "\n" for r in rows)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("at"))
    make_synth_clotho(d, "clotho_dev", n=4, seconds=1.05)
    make_synth_clotho(d, "clotho_val", n=5, seconds=1.05)  # the last eval batch is one clip short
    make_synth_clotho(d, "clotho_test", n=3, seconds=1.05)
    # edge cases: a clip with 3 captions, one with none, one with an over-long caption
    os.makedirs(os.path.join(d, "clotho_edge", "aclip"))
    for i in range(4):
        _tone_wav(os.path.join(d, "clotho_edge", "aclip", f"e{i}.wav"), 1.05, freq=250 + 60 * i, seed=i)
    _write_csv(d, "clotho_edge", [
        ["e0.wav", "a dog barks", "a dog barking loudly", "the dog", "", ""],
        ["e1.wav", "", "", "", "", ""],
        ["e2.wav", LONG, "rain", "heavy rain", "rain on a roof", "light rain"],
        ["e3.wav", "a car", "cars passing", "a car horn", "traffic", "an engine"],
    ])
    os.makedirs(os.path.join(d, "audiocaps_edge", "aclip"))
    recs = [{"id": "c0", "captions": ["a bird sings", "birds chirp"]}, {"id": "c1", "caption": "a door"},
            {"id": "c2", "captions": []}, {"id": "c3", "captions": [LONG, "wind"], "dir": "audiocaps_edge"}]
    for i, r in enumerate(recs):
        _tone_wav(os.path.join(d, "audiocaps_edge", "aclip", f"{r['id']}.wav"), 1.05, freq=300 + 50 * i,
                  seed=i)
    with open(os.path.join(d, "audiocaps_edge.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    return d


def _cfg(data, run_dir, *extra):
    return [
        "+running=clotho", *TINY_MODEL, "+model/loss=ce", "worker=CLAP", "monitor=LAMonitor",
        "compute_dtype=float32", f"running.data_root={data}", "running.data_name=clotho_dev",
        "running.eval_name=clotho_val", "running.test_name=clotho_test", "running.batch_size=2",
        "running.epochs=2", "running.peep_rate=1", "running.save_rate=3", "running.save_epoch=True",
        f"alias_root={run_dir}", f"model_root={run_dir}", "model_name=run", "model_file=",
        "eval=False", "metrics_jsonl=True", "loader_backend=thread", "num_proc=1", *extra,
    ]


def _losses(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f if line.strip()]


def _recording(fn, into):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        into.append(out)
        return out
    return wrapped


def _run_both(data, tmp_path_factory, *extra, record=True):
    """The JAX monitor and the port's trainer over the same steps from one
    init: (JAX monitor, port trainer, JAX 1-vs-k records, port's, init, the
    port's grads at every step)."""
    mp = pytest.MonkeyPatch()
    try:
        pin_numpy_fbank(mp)
        rec_jax, rec_port = [], []
        if record:
            mp.setattr(jax_monitors, "one_vs_k_retrieval",
                       _recording(jax_monitors.one_vs_k_retrieval, rec_jax))
            mp.setattr(monitors, "one_vs_k_retrieval", _recording(monitors.one_vs_k_retrieval, rec_port))
        jmon = jax_build_monitor(jax_compose(_cfg(data, str(tmp_path_factory.mktemp("jax")), *extra)))
        init = jax.tree_util.tree_map(np.asarray, jmon.state.full_params())
        np.random.seed(0)
        jmon.learn()
        tr = build_monitor(_cfg(data, str(tmp_path_factory.mktemp("port")), *extra), device="cpu")
        from_jax.load_params(tr.model, init)
        step_grads, apply = [], tr.state.optimizer.apply

        def apply_and_record(grads):
            step_grads.append({k: g.detach().numpy().copy() for k, g in grads.items()})
            return apply(grads)

        tr.state.optimizer.apply = apply_and_record
        np.random.seed(0)
        tr.learn()
    finally:
        mp.undo()
    return jmon, tr, rec_jax, rec_port, from_jax.model_state_dict(init), step_grads


@pytest.fixture(scope="module", params=[True, False], ids=["text_frozen", "text_trained"])
def loops(request, data, tmp_path_factory):
    return request.param, *_run_both(data, tmp_path_factory, f"model.text.freeze={request.param}")


def test_build_monitor_gives_an_la_trainer(loops):
    freeze, _, tr, *_ = loops
    assert type(tr) is LATrainer and tr.device.type == "cpu"
    assert tr.batch_keys == ("audio", "text") and tr.loader.device_put_fn is tr.device_put
    assert any(k.startswith("text.") for k in tr.frozen) == freeze
    assert any(k.startswith("text.") for k in tr.trainable) != freeze


def test_loop_losses_match_the_jax_trainer(loops):
    _, jmon, tr, *_ = loops
    want, got = _losses(jmon.out_dir), _losses(tr.out_dir)
    assert len(got) == len(want) == 4 and tr.global_step == jmon.global_step == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(set(np.round(got, 3))) == 4  # the steps saw different batches


def test_loop_final_params_match_the_jax_trainer(loops):
    _, jmon, tr, _, _, init, step_grads = loops
    want = from_jax.model_state_dict(jax.tree_util.tree_map(np.asarray, jmon.state.params))
    assert sorted(want) == sorted(tr.trainable) and len(step_grads) == 4
    left_out = 0
    for k, w in want.items():
        g = np.abs(np.stack([s[k] for s in step_grads]))
        rms = np.sqrt((g ** 2).mean(axis=tuple(range(1, g.ndim)), keepdims=True))
        # an exact zero (the patch weights over frames SpecAugment masked in
        # both clips of a batch) takes no step from rounding noise: it is held
        keep = ~((g < ADAM_NEAR_ZERO * rms) & (g > 0)).any(0)
        left_out += int((~keep).sum())
        np.testing.assert_allclose(tr.trainable[k].detach().numpy()[keep], w[keep], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert left_out <= 0.01 * sum(w.size for w in want.values()), left_out
    assert max(np.abs(w - init[k]).max() for k, w in want.items()) > 1e-3  # the params moved


def test_save_time_and_test_evals_match_the_jax_trainer(loops):
    _, _, _, want, got, _, _ = loops
    # saves at 2 (epoch end), 3 and 4 (epoch end), each an eval and a TEST; a TEST at the end
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for part, vals in w.items():
            for k, v in vals.items():
                assert g[part][k] == pytest.approx(v, abs=1e-6), (part, k)


def _logged_reports(out_dir):
    """Each save's path and the eval report the run logged after it."""
    with open(os.path.join(out_dir, "train_0.out")) as f:
        lines = [line.rstrip("\n").split(": ", 1)[-1] for line in f]
    return [(m.group(1), lines[i + 1]) for i, line in enumerate(lines)
            if (m := re.match(r"saving the checkpoint to (\S+)$", line))]


def test_repeated_retrieval_reports_each_saved_step_as_the_run_did(loops):
    _, _, tr, *_ = loops
    logged = _logged_reports(tr.out_dir)
    assert [os.path.basename(p) for p, _ in logged] == ["00000002", "00000003", "00000004"]
    assert all(r.startswith("A->T") for _, r in logged)
    reports = build_monitor(_cfg(str(tr.cfg.running.data_root), str(tr.cfg.alias_root), "eval=True",
                                 "model_file=train_0.out", f"model.text.freeze={tr.cfg.model.text.freeze}"),
                            device="cpu").learn()
    assert reports == [f"{p}: {r}" for p, r in logged]


def test_text_embeddings_match_the_jax_trainer(loops, tmp_path):
    """From the JAX trainer's final params: a trained text tower's params
    differ between the packages within the param check's bound."""
    _, jmon, tr, *_ = loops
    own = {k: v.clone() for k, v in tr.model.state_dict().items()}
    from_jax.load_params(tr.model, jax.tree_util.tree_map(np.asarray, jmon.state.full_params()))
    try:
        _check_text_embeddings(jmon, tr, tmp_path)
    finally:
        tr.model.load_state_dict(own)


def _check_text_embeddings(jmon, tr, tmp_path):
    texts = np.concatenate([b["text"] for b in tr.evalloader])
    got = np.load(tr.encode_text_dump(texts, str(tmp_path / "port.npz")))["v"]
    want = np.load(jmon.encode_text_dump(texts, str(tmp_path / "jax.npz")))["v"]
    assert got.shape == want.shape == (len(texts), 32)
    np.testing.assert_allclose(got, want, atol=1e-5)
    port_root = tr.encode_text(out_root=str(tmp_path / "port"))
    jax_root = jmon.encode_text(loader=jmon.evalloader, out_root=str(tmp_path / "jax"))
    names = sorted(os.listdir(jax_root))
    assert names == sorted(os.listdir(port_root)) == [f"a{i}.npz" for i in range(5)]
    for n in names:
        g, w = np.load(os.path.join(port_root, n))["v"], np.load(os.path.join(jax_root, n))["v"]
        assert g.shape == w.shape == (5, 32)
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_encode_text_writes_under_the_clip_model_name(loops, tmp_path):
    _, _, tr, *_ = loops
    root = tr.encode_text()
    assert root == os.path.join(str(tr.cfg.running.data_root), "caption", "audiocap", "vit-b32")
    assert sorted(os.listdir(root)) == [f"a{i}.npz" for i in range(5)]
    # the training loader's batches come placed through the pinned copy: one caption a clip
    root = tr.encode_text(loader=tr.loader, out_root=str(tmp_path))
    assert sorted(os.listdir(root)) == [f"a{i}.npz" for i in range(4)]
    assert all(np.load(os.path.join(root, f))["v"].shape == (1, 32) for f in os.listdir(root))


# --------------------------------------------------------------- captioning
@pytest.fixture(scope="module")
def caption_loops(data, tmp_path_factory):
    return _run_both(data, tmp_path_factory, *CAPTION, "running.save_epoch=False",
                     "running.save_rate=1000000", "running.test_name=", record=False)


def test_caption_loop_losses_match_the_jax_trainer(caption_loops):
    jmon, tr, *_ = caption_loops
    want, got = _losses(jmon.out_dir), _losses(tr.out_dir)
    assert tr.model.text is None and tr.state.loss_kwargs == {"retrieval": False}
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_caption_report_matches_the_jax_trainer(caption_loops):
    jmon, tr, *_ = caption_loops
    dec, variables = jmon._decode_step(), jmon.eval_variables()
    aidx = jmon.batch_keys.index("audio")
    all_equal, rows = True, 0
    for batch in tr.evalloader:
        ids_j, logits = dec(variables, jmon.eval_frontend_args(batch)[aidx])
        ids_j, logits = np.asarray(ids_j), np.asarray(logits, np.float32)
        ids_p = tr._decode(batch["audio"])
        assert ids_p.shape == ids_j.shape
        top2 = np.sort(logits, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]  # [B, steps]
        for row_p, row_j, m in zip(ids_p, ids_j, margin):
            rows += 1
            diff = np.flatnonzero(row_p != row_j)
            if diff.size:
                all_equal = False
                assert m[diff[0] - 1] <= MARGIN, (row_p, row_j, m)  # ids[0] is the start token
    assert rows == 6  # 5 clips and one pad row
    got, want = tr.caption_report(tr.evalloader), jmon.caption_report(jmon.evalloader)
    assert got.startswith("BLEU-1 = ") and "CIDEr-D" in got and "@ 5 |" in got
    if all_equal:
        assert got == want


# --------------------------------------------------------------------- gate
@pytest.mark.parametrize("bound,evaluates", [("0.5", False), ("inf", True), (None, True)])
def test_the_ce_gate_skips_and_logs_or_evaluates(data, tmp_path, bound, evaluates):
    extra = [] if bound is None else [f"running.eval_loss_bound={bound}"]
    tr = build_monitor(_cfg(data, str(tmp_path), "running.epochs=1", "running.save_rate=1000000",
                            "running.test_name=", *extra), device="cpu")
    tr.learn()  # one epoch: a save at its end, gated on its last loss (~1.4-2.2 < 5)
    with open(os.path.join(tr.out_dir, "train_0.out")) as f:
        log = f.read()
    assert ("save-time eval skipped: loss" in log) != evaluates
    assert ("A->T:" in log) == evaluates
    if bound is None:  # the default bound is 5
        assert tr.mid_train_eval_ok(4.99) and not tr.mid_train_eval_ok(5.0)


# ----------------------------------------------------------------- datasets
def _loaders(data, name, train, *extra):
    over = ["+running=clotho", *TINY_MODEL, "+model/loss=ce", "worker=CLAP",
            f"running.data_root={data}", "running.batch_size=2", "loader_backend=thread",
            "num_proc=1", "running.prompt=the sound of", *extra]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        np.random.seed(3)
        want = jax_audio_text.build_audio_text_dataloader(jax_compose(over), name, train)
        np.random.seed(3)
        got = audio_text.build_audio_text_dataloader(compose(over), name, train)
    return got, want, [str(w.message) for w in caught]


def _assert_same(got, want, path="item"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


@pytest.mark.parametrize("name", ["clotho_edge", "audiocaps_edge"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("np_rnd", [False, True])
def test_datasets_match_the_jax_package_bitwise(data, monkeypatch, name, train, np_rnd):
    pin_numpy_fbank(monkeypatch)
    got, want, caught = _loaders(data, name, train, f"running.np_rnd={np_rnd}")
    assert sum("dropping 1 record(s) without any caption" in m for m in caught) == 2  # each package
    assert got.dataset.records == want.dataset.records and len(got.dataset) == 3
    recs = got.dataset.records
    assert all(c.startswith("the sound of ") for r in recs for c in r["captions"])
    assert any(len(c) > 77 for r in recs for c in r["captions_bpe"])
    assert got.dataset.eval_k == want.dataset.eval_k == (5 if name == "clotho_edge" else 2)
    for i in range(len(got.dataset)):
        np.random.seed(10 + i)
        item_w = want.dataset[i]
        np.random.seed(10 + i)
        _assert_same(got.dataset[i], item_w, f"{name}[{i}]")
        text = item_w["text"].reshape(-1, 77)
        assert (text.argmax(-1) == (text != 0).sum(-1) - 1).all()  # the EOT is the last, largest id
    for b_got, b_want in zip(*(iter_seeded(loader) for loader in (got, want))):
        _assert_same(b_got, b_want, f"{name} batch")
        assert b_got["text"].shape == ((2, 77) if train else (2 * got.dataset.eval_k, 77))


def iter_seeded(loader):
    np.random.seed(5)
    return list(loader)


def test_a_short_clip_pads_its_captions_cyclically(data):
    got, _, _ = _loaders(data, "clotho_edge", False)
    item = got.dataset[0]  # 3 captions, eval_k 5
    caps = got.dataset.records[0]["captions_bpe"]
    want = np.stack([got.dataset._pad(caps[i % 3]) for i in range(5)])
    assert np.array_equal(item["text"], want) and np.array_equal(item["text"][3], item["text"][0])


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("extra,error,item", [
    # ported: the image-text loader and the packed AT dataset are reached (this root holds
    # neither an image-text index nor a pack)
    pytest.param(["running.dataloader=lv"], FileNotFoundError, "clotho_dev.jsonl", id="extra0-A12"),
    pytest.param(["running.data_name=pak_clotho"], FileNotFoundError, "pak_clotho.pak",
                 id="extra1-A11"),
    pytest.param(["running.grad_cache.alive=True"], NotImplementedError, "A15", id="extra2-A15"),
    # ported: async_ckpt builds and the pack is reached
    pytest.param(["async_ckpt=True", "running.data_name=pak_clotho"], FileNotFoundError,
                 "pak_clotho.pak", id="extra3-A7"),
])
def test_what_is_not_ported_is_refused_by_name(data, tmp_path, extra, error, item):
    with pytest.raises(error, match=item):
        build_monitor(_cfg(data, str(tmp_path), *extra), device="cpu")
