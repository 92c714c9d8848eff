"""The port's VA trainer loop (vipant_tpu_torch/train/trainer.py,
train/checkpoint.py) against the JAX package's ``Trainer`` on the tiny
config ``TINY_MODEL`` of tests/test_trainers.py in fp32 and the synthetic
index of tests/data_synth.py, on the CPU:

- loop parity: both trainers from one init (the JAX params carried over by
  ``ckpt/from_jax.load_params``), four steps over two epochs of the wav
  index with SpecAugment on (the thread backend, one worker, the JAX
  package on its NumPy fbank; np.random seeded alike before each ``learn``):
  each step's loss within rtol 1e-4, the final trainable params within atol
  1e-5, the save-time evals' retrieval metrics within 1e-6; under the
  flagship's LARS (no warmup, rates raised so that four steps move the
  params by ~1e-2) and under ``TINY_MODEL``'s Adam. Adam divides each grad by
  its own running norm, so a grad that is zero in exact arithmetic (the key
  third of the attention's ``in_proj_bias``: softmax ignores a shift shared
  by all keys) moves its param by steps of ~lr drawn from rounding noise,
  which differ between the two packages (5e-5 and 1.5e-4 after four steps,
  measured). Its first step is the sign of the grad, so the same holds for
  any element whose grad is near zero at some step (a few in ``c_fc`` and
  the patch conv missed by 1e-5 to 3e-5, measured): under Adam the param
  check leaves out each element whose grad at some step is below 1e-3 of
  its tensor's rms (0.6 % of them), and holds the k third's grad to
  rounding;
- exact resume: a run saved at step 2 (an epoch's end) or 3 (mid-epoch),
  then a fresh trainer resumed from that step directory, ends bitwise where
  the uninterrupted run ends (params, optimizer, step, RNG), on the process
  backend whose items are seeded one by one;
- the ``model.npz`` export round-trips through ``ckpt/from_jax`` bitwise, and
  the port's and the JAX package's engines give the same audio embeddings
  from the step directory (cosine >= 0.9999; the JAX engine seeds the image
  tower the export leaves out from a synthetic CLIP file, the port's from
  the step's ``state.pt``);
- an overfit through the loop: 8 pairs, Adam; the loss falls below half its
  start and the eval on the same pairs finds every image's audio (I->A R@1
  100);
- the loop's options: ``eval=True``, ``eval_norms``, ``metrics_jsonl``,
  ``keep_last_ckpts``, ``halt_on_nan``, ``build_monitor``, the run files
  under ``TMPDIR`` by default, the pinned put built for a training loader
  only.
"""

import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

import vipant_tpu.data.transforms_audio as jax_transforms_audio
import vipant_tpu.train.trainer as jax_trainer_module
from vipant_tpu.config import compose as jax_compose
from vipant_tpu.serve import InferenceEngine as JaxEngine
from vipant_tpu.train import build_monitor as jax_build_monitor
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer, build_monitor
import vipant_tpu_torch.train.trainer as trainer_module

from data_synth import make_synth_va_index, make_synth_va_npz_index
from test_trainers import TINY_MODEL
from torch_oracle import TorchText, TorchVisual, clip_state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("va"))
    make_synth_va_index(d, "train", n=8, seconds=1.05)
    make_synth_va_index(d, "val", n=5, seconds=1.05)
    make_synth_va_npz_index(d, "npz_train", n=8, frames=100)  # max_len: no random crop
    return d


def _cfg(data, run_dir, *extra):
    return [
        "+running=bimodal", *TINY_MODEL, "+model/loss=ce", "worker=CVAP", "monitor=VAMonitor",
        "compute_dtype=float32", f"running.data_root={data}", "running.data_name=train",
        "running.eval_name=val", "running.batch_size=4", "running.epochs=2",
        "running.peep_rate=1", "running.save_rate=1000000", "running.save_epoch=True",
        f"alias_root={run_dir}", f"model_root={run_dir}", "model_name=run", "model_file=",
        "eval=False", "metrics_jsonl=True", "loader_backend=thread", "num_proc=1", *extra,
    ]


LARS = ["optimizer.use_lars=True", "optimizer.warmup_epoch=0", "optimizer.lr_weight=10",
        "optimizer.lr_bias=0.24", "optimizer.eta=0.01"]
OPTIMIZERS = {"lars": LARS, "adam": []}  # Adam: TINY_MODEL's own optimizer
KEY_BIAS = "attn.in_proj_bias"  # [q | k | v] biases; the k third's grad is zero in exact arithmetic
KEY_GRAD_ROUNDING = 1e-5  # the k third's largest grad against the q and v thirds'
# under Adam: a grad below this share of its tensor's rms at some step leaves
# its element's update to rounding (the packages' grads agree to ~1e-6 of it)
ADAM_NEAR_ZERO = 1e-3


def _losses(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f if line.strip()]


def _recording(fn, into):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        into.append(out)
        return out
    return wrapped


def _key_third(v):
    """``in_proj_bias`` without its k third, and that third."""
    c = v.shape[0] // 3
    return np.concatenate([v[:c], v[2 * c:]]), v[c:2 * c]


@pytest.fixture(scope="module", params=sorted(OPTIMIZERS))
def loops(request, data, tmp_path_factory):
    """The JAX trainer and the port's over the same 4 steps from one init:
    (optimizer, JAX monitor, port trainer, JAX retrieval records, port's,
    init, the port's grads at every step)."""
    opt = OPTIMIZERS[request.param]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_transforms_audio, "host_fbank", jax_transforms_audio._fbank_np)
        sym_jax, sym_port = [], []
        mp.setattr(jax_trainer_module, "symmetric_retrieval",
                   _recording(jax_trainer_module.symmetric_retrieval, sym_jax))
        mp.setattr(trainer_module, "symmetric_retrieval",
                   _recording(trainer_module.symmetric_retrieval, sym_port))
        over = _cfg(data, str(tmp_path_factory.mktemp("jax")), *opt)
        jmon = jax_build_monitor(jax_compose(over))
        init = jax.tree_util.tree_map(np.asarray, jmon.state.full_params())
        np.random.seed(0)
        jmon.learn()
        tr = Trainer(_cfg(data, str(tmp_path_factory.mktemp("port")), *opt), device="cpu")
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
    return request.param, jmon, tr, sym_jax, sym_port, from_jax.model_state_dict(init), step_grads


def test_loop_losses_match_the_jax_trainer(loops):
    _, jmon, tr, _, _, _, _ = loops
    want, got = _losses(jmon.out_dir), _losses(tr.out_dir)
    assert len(got) == len(want) == 4 and tr.global_step == jmon.global_step == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(set(np.round(got, 3))) == 4  # the steps saw different batches


def test_loop_final_params_match_the_jax_trainer(loops):
    opt, jmon, tr, _, _, init, step_grads = loops
    want = from_jax.model_state_dict(jax.tree_util.tree_map(np.asarray, jmon.state.params))
    assert sorted(want) == sorted(tr.trainable) and len(step_grads) == 4
    left_out = 0
    for k, w in want.items():
        got, keep = tr.trainable[k].detach().numpy(), np.ones(w.shape, bool)
        if opt == "adam":
            g = np.abs(np.stack([s[k] for s in step_grads]))
            rms = np.sqrt((g ** 2).mean(axis=tuple(range(1, g.ndim)), keepdims=True))
            keep = (g >= ADAM_NEAR_ZERO * rms).all(0)
            left_out += int((~keep).sum())
            if k.endswith(KEY_BIAS):  # the k third is among what is left out
                assert not _key_third(keep)[1].any(), k
        np.testing.assert_allclose(got[keep], w[keep], rtol=0, atol=1e-5, err_msg=k)
    assert left_out <= 0.01 * sum(w.size for w in want.values()), left_out
    assert max(np.abs(w - init[k]).max() for k, w in want.items()) > 1e-3  # the params moved
    # the k third's grad is rounding beside the q and v thirds', at every step
    for step in step_grads:
        for k, g in step.items():
            if k.endswith(KEY_BIAS):
                qv, key = _key_third(np.abs(g))
                assert key.max() <= KEY_GRAD_ROUNDING * qv.max(), (k, key.max(), qv.max())


def test_save_time_evals_match_the_jax_trainer(loops):
    _, _, _, want, got, _, _ = loops
    assert len(got) == len(want) == 2  # at each epoch's end
    for g, w in zip(got, want):
        for direction in ("12", "21"):
            for k, v in w[direction].items():
                assert g[direction][k] == pytest.approx(v, abs=1e-6), (direction, k)


# ------------------------------------------------------------ exact resume
def _resume_cfg(data, run_dir, save_rate, *extra):
    return _cfg(data, run_dir, "loader_backend=process", "num_proc=2", "running.eval_name=",
                "running.save_epoch=False", f"running.save_rate={save_rate}", *extra)


def _state(tr):
    sd = tr.state.state_dict()
    return sd["step"], sd["params"], sd["opt_state"], sd["rng"]


def _assert_bitwise(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_bitwise(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{path}/{i}")
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def uninterrupted(data, tmp_path_factory):
    run = str(tmp_path_factory.mktemp("a"))
    tr = Trainer(_resume_cfg(data, run, 2), device="cpu")  # saves at steps 2 and 4
    tr.learn()
    return tr, run


@pytest.mark.parametrize("at", [2, 3])
def test_resume_is_bitwise_the_uninterrupted_run(data, uninterrupted, tmp_path, at):
    a, _ = uninterrupted
    run = str(tmp_path)
    b1 = Trainer(_resume_cfg(data, run, at), device="cpu")
    b1.learn()
    b2 = Trainer(_resume_cfg(data, run, 10 ** 9, f"model_file={at:08d}"), device="cpu")
    assert b2.global_step == b2.state.step == b2.state.optimizer.count == at
    b2.learn()
    assert b2.global_step == a.global_step == 4
    _assert_bitwise(_state(b2), _state(a))


def test_checkpoint_directory_layout(uninterrupted):
    _, run = uninterrupted
    steps = sorted(d for d in os.listdir(os.path.join(run, "run")) if d.isdigit())
    assert steps == ["00000002", "00000004"]
    step = os.path.join(run, "run", "00000004")
    assert sorted(os.listdir(step)) == ["COMMITTED", "config.json", "model.npz", "state.pt"]
    with open(os.path.join(step, "config.json")) as f:
        assert json.load(f)["running"]["save_rate"] == 2


# ------------------------------------------------------------------ export
def test_model_npz_round_trips_through_from_jax(uninterrupted):
    a, run = uninterrupted
    params = from_jax.read_npz(os.path.join(run, "run", "00000004", "model.npz"))
    assert sorted(params) == ["audio", "loss"]
    back = from_jax.model_state_dict(params)
    own = {k: p.detach().numpy() for k, p in a.model.named_parameters()
           if k.split(".", 1)[0] in ("audio", "loss")}
    assert sorted(back) == sorted(own)
    for k, v in own.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes(), k


def test_both_engines_serve_the_export_alike(uninterrupted, tmp_path):
    a, run = uninterrupted
    torch.manual_seed(0)
    clip = clip_state_dict(TorchVisual(width=64, layers=2, heads=4, embed_dim=32),
                           TorchText(width=32, layers=2, heads=4, embed_dim=32))
    torch.save(clip, tmp_path / "tinyclip.pt")
    over = ["+running=bimodal", *TINY_MODEL, "+model/loss=ce", "worker=CVAP",
            "compute_dtype=float32", f"model_root={run}", "model_name=run",
            "model_file=00000004", "eval=True"]
    port = InferenceEngine(over, batch_size=4, device="cpu")
    jax_eng = JaxEngine(over + [f"running.clip_model_root={tmp_path}",
                                "running.clip_model_name=tinyclip"], batch_size=4)
    fb = np.random.default_rng(0).standard_normal((6, 100, 128)).astype(np.float32)
    got, want = port.embed_audio(fb), np.asarray(jax_eng.embed_audio(fb))
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert got.shape == want.shape == (6, 32) and cos.min() >= 0.9999, cos
    # the step's own audio features: the engine serves the trained tower
    feats = a.model.encode_audio(torch.as_tensor(fb[:, None]), train=False).detach().numpy()
    np.testing.assert_allclose(got, feats, atol=1e-5)
    for k, p in port.model.named_parameters():  # the image tower from state.pt
        if k.startswith("image."):
            assert torch.equal(p, a.frozen[k]), k


# ----------------------------------------------------------------- overfit
def test_overfits_eight_pairs_through_the_loop(data, tmp_path):
    tr = Trainer(_cfg(data, str(tmp_path), "running.data_name=npz_train",
                      "running.eval_name=npz_train", "running.batch_size=8", "running.epochs=40",
                      "running.save_epoch=False", "running.audio.transform_fbank=False",
                      "optimizer.lr=4.0e-3"), device="cpu")
    tr.learn()
    losses = _losses(tr.out_dir)
    assert len(losses) == 40 and losses[0] > 3.0, losses[:3]
    assert np.mean(losses[-3:]) < 0.5 * losses[0], losses
    sym = trainer_module.symmetric_retrieval(*(lambda d: (d["x1"], d["x2"]))(
        tr.collect_features(tr.evalloader)))
    assert sym["12"]["R@1"] == 100.0, sym


# ------------------------------------------------------------- the options
def test_eval_mode_gold_report_and_eval_norms(data, tmp_path):
    over = _cfg(data, str(tmp_path), "eval=True")
    report = Trainer(over, device="cpu").learn()
    assert report.startswith("I->A") and "@ 5" in report
    gold = tmp_path / "gold.jsonl"
    gold.write_text("".join(json.dumps({"id": f"clip{i}", "labels": [f"c{i % 2}"]}) + "\n"
                            for i in range(5)))
    report = Trainer(over + [f"running.gold_file={gold}"], device="cpu").learn()
    assert "| I->A P@1" in report and "mAP" in report
    tr = Trainer(over + ["running.audio.eval_norms=True"], device="cpu")
    mean, std = tr.learn()
    feats = np.concatenate([b["audio"][: b["_count"]] for b in tr.evalloader]).astype(np.float64)
    assert feats.shape[0] == 5
    assert mean == pytest.approx(feats.mean(), rel=1e-5) and std == pytest.approx(feats.std(), rel=1e-4)


@pytest.mark.parametrize("given", [True, False])
def test_profile_window_writes_a_trace(data, tmp_path, monkeypatch, given):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the shipped dir goes under it
    tr = Trainer(_cfg(data, str(tmp_path), "running.eval_name=", "running.save_epoch=False",
                      "profile.alive=True", "profile.start_step=2", "profile.num_steps=2",
                      *([f"profile.dir={tmp_path}/prof"] if given else [])), device="cpu")
    tr.learn()
    prof = tmp_path / ("prof" if given else "vipant_profile")
    assert os.listdir(prof) == ["trace_00000004.json"]  # steps 2 to 4: two epochs


def test_the_shipped_run_root_is_under_the_temp_dir(data, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    over = [o for o in _cfg(data, "unused", "running.eval_name=", "running.epochs=1")
            if not o.startswith(("alias_root=", "model_root="))]
    tr = Trainer(over, device="cpu")
    assert tr.out_dir == os.path.join(str(tmp_path), "vipant", "run")
    tr.learn()
    resumed = Trainer(over + ["model_file=00000002"], device="cpu")  # model_root alike
    assert resumed.global_step == 2 and os.path.isdir(os.path.join(tr.out_dir, "00000002"))


def test_keep_last_and_halt_on_nan(data, tmp_path):
    tr = Trainer(_cfg(data, str(tmp_path), "running.save_rate=1", "running.save_epoch=False",
                      "running.eval_name=", "keep_last_ckpts=2"), device="cpu")
    tr.learn()
    assert sorted(d for d in os.listdir(tr.out_dir) if d.isdigit()) == ["00000003", "00000004"]
    bad = Trainer(_cfg(data, str(tmp_path / "nan"), "running.eval_name="), device="cpu")
    with torch.no_grad():
        next(iter(bad.trainable.values())).fill_(float("nan"))
    with pytest.raises(FloatingPointError):
        bad.learn()


def test_monitor_registry_names_what_is_not_ported(data, tmp_path):
    assert isinstance(build_monitor(compose(_cfg(data, str(tmp_path), "eval=True")), device="cpu"),
                      Trainer)
    for name, item in (("LAMonitor", "A10"), ("ASMonitor", "A11"), ("ESCMonitor", "A11"),
                       ("VALMonitor", "A12"), ("VASMonitor", "A12")):
        with pytest.raises(NotImplementedError, match=item):
            build_monitor(compose(_cfg(data, str(tmp_path), f"monitor={name}")), device="cpu")


def test_only_a_training_loader_gets_the_pinned_put(data, tmp_path):
    train = Trainer(_cfg(data, str(tmp_path)), device="cpu")
    assert train.loader.device_put_fn is train.device_put is not None
    assert Trainer(_cfg(data, str(tmp_path), "eval=True"), device="cpu").device_put is None
    assert Trainer(_cfg(data, str(tmp_path)), device="cpu", steps_per_epoch=2).device_put is None
