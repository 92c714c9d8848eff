"""The port's VA trainer with the device frontend against the JAX package's
``VAMonitor``, on the CPU, on the tiny config ``TINY_MODEL`` in fp32 and
the synthetic wav index of tests/data_synth.py:

- ``running.audio.on_device``, ``wav_int16`` and ``running.image_uint8``:
  int16 waveforms and uint8 frames ship, the card-side frontend (rescale,
  fbank, SpecAugment, CLIP normalisation) runs inside the step. Two LARS
  steps (one epoch of 8 clips) from one init, with SpecAugment off and
  with the same masks injected into both (the JAX package's draws come from
  its PRNG key, the port's from its generator): each step's loss within
  rtol 1e-4 and the trainable params within atol 1e-5, the tolerances of
  tests/test_torch_trainer_loop.py; the epoch-end eval's retrieval metrics
  within 1e-6;
- the eval runs the device frontend (``eval_frontend_args``): the on-device
  trainer's eval features and report match those of a host-fbank trainer
  on the same weights (a raw waveform handed to ``encode_audio`` would be
  read as a precomputed embedding);
- the npz source with ``ship_bf16`` and ``ship_int16``: one step each from
  one init, against the JAX trainer;
- ``LAMonitor`` runs unchanged with ``on_device``: its dataset ships
  fbanks, which pass through the frontend;
- exact resume on the device frontend (int16 waveforms, SpecAugment drawing
  from the train state's generator): a run saved mid-epoch and resumed by
  a fresh trainer ends bitwise where the uninterrupted run ends (params,
  optimizer, step, RNG), as tests/test_torch_trainer_loop.py holds for the
  host frontend.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipant_tpu.train.trainer as jax_trainer_module
from vipant_tpu.config import compose as jax_compose
from vipant_tpu.ops import specaugment as jax_specaugment
from vipant_tpu.train import build_monitor as jax_build_monitor
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.ops import specaugment
from vipant_tpu_torch.train import Trainer, build_monitor
import vipant_tpu_torch.train.trainer as trainer_module

from data_synth import make_synth_clotho, make_synth_va_index, make_synth_va_npz_index
from fbank_route import pin_numpy_fbank
from test_torch_trainer_loop import (LARS, _assert_bitwise, _cfg, _losses, _recording, _resume_cfg,
                                     _state)
from torch_dist_worker import one_rank

SHIP = ["running.audio.on_device=True", "running.audio.wav_int16=True", "running.image_uint8=True"]
ONE_EPOCH = ["running.epochs=1"] + LARS  # 8 clips at B = 4: two steps, an eval at the end
# injected SpecAugment uniforms (width, start), [B, 1] each, by axis length: 128 mels, 100 frames
_U = np.random.default_rng(7).random((2, 2, 4, 1)).astype(np.float32)
UNIFORMS = {128: (_U[0, 0], _U[0, 1]), 100: (_U[1, 0], _U[1, 1])}


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
    make_synth_va_npz_index(d, "npz_train", n=8, frames=100)
    return d


@pytest.fixture(scope="module")
def short(tmp_path_factory):
    """Clips shorter than the crop (padded), in a root of their own: the
    synthetic indexes of one root share their clip files."""
    d = str(tmp_path_factory.mktemp("short"))
    make_synth_va_index(d, "val", n=5, seconds=0.6)
    return d


def _jax_mask(key, batch, axis_len, mask_param):
    """``vipant_tpu.ops.specaugment._axis_mask`` on the injected uniforms."""
    u_width, u_start = (jnp.asarray(u) for u in UNIFORMS[axis_len])
    width = u_width * float(mask_param)
    start = u_start * (axis_len - width)
    pos = jnp.arange(axis_len, dtype=jnp.float32)[None, :]
    return (pos >= start) & (pos < start + width)


def _run_both(data, tmp_path_factory, *extra, inject=False):
    """The JAX monitor and the port's trainer over the same steps from one
    init: (JAX monitor, port trainer, JAX retrieval records, port's)."""
    mp = pytest.MonkeyPatch()
    try:
        pin_numpy_fbank(mp)
        sym_jax, sym_port = [], []
        mp.setattr(jax_trainer_module, "symmetric_retrieval",
                   _recording(jax_trainer_module.symmetric_retrieval, sym_jax))
        mp.setattr(trainer_module, "symmetric_retrieval",
                   _recording(trainer_module.symmetric_retrieval, sym_port))
        if inject:
            mp.setattr(jax_specaugment, "_axis_mask", _jax_mask)
            order = itertools.cycle([UNIFORMS[128], UNIFORMS[100]])  # a frequency mask, then a time mask
            mp.setattr(specaugment, "axis_uniforms",
                       lambda generator, batch: tuple(torch.from_numpy(u) for u in next(order)))
        jmon = jax_build_monitor(jax_compose(_cfg(data, str(tmp_path_factory.mktemp("jax")), *extra)))
        init = jax.tree_util.tree_map(np.asarray, jmon.state.full_params())
        np.random.seed(0)
        jmon.learn()
        tr = Trainer(one_rank(_cfg(data, str(tmp_path_factory.mktemp("port")), *extra)), device="cpu")
        from_jax.load_params(tr.model, init)
        np.random.seed(0)
        tr.learn()
    finally:
        mp.undo()
    return jmon, tr, sym_jax, sym_port


MODES = {"specaugment_off": ["running.audio.transform_fbank=False"], "specaugment_injected": []}


@pytest.fixture(scope="module")
def wav_runs(data, tmp_path_factory):
    """mode -> (JAX monitor, port trainer, JAX retrieval records, port's)."""
    return {mode: _run_both(data, tmp_path_factory, *SHIP, *ONE_EPOCH, *extra,
                            inject=mode == "specaugment_injected") for mode, extra in MODES.items()}


def _assert_params_match(jmon, tr):
    want = from_jax.model_state_dict(jax.tree_util.tree_map(np.asarray, jmon.state.params))
    assert sorted(want) == sorted(tr.trainable)
    for k, w in want.items():
        np.testing.assert_allclose(tr.trainable[k].detach().numpy(), w, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_on_device_steps_match_the_jax_trainer(wav_runs, mode):
    jmon, tr, _, _ = wav_runs[mode]
    assert tr.on_device_audio and tr.image_uint8 and tr.needs_device_frontend
    want, got = _losses(jmon.out_dir), _losses(tr.out_dir)
    assert len(got) == len(want) == 2 and tr.global_step == jmon.global_step == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _assert_params_match(jmon, tr)


def test_the_injected_masks_reach_both_steps(wav_runs):
    """SpecAugment runs inside both trainers' steps: the masks change every
    loss of the epoch, in each package."""
    for trainer in (lambda run: run[0], lambda run: run[1]):
        off, on = (_losses(trainer(wav_runs[m]).out_dir) for m in sorted(MODES))
        assert all(abs(a - b) > 1e-4 * abs(a) for a, b in zip(off, on)), (off, on)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_on_device_eval_matches_the_jax_trainer(wav_runs, mode):
    _, _, want, got = wav_runs[mode]
    assert len(got) == len(want) == 1  # at the epoch's end
    for direction in ("12", "21"):
        for k, v in want[0][direction].items():
            assert got[0][direction][k] == pytest.approx(v, abs=1e-6), (direction, k)


@pytest.mark.parametrize("clips", ["full", "short"])
def test_the_eval_runs_the_device_frontend(wav_runs, data, short, tmp_path, clips):
    """The on-device trainer's eval features and report against a trainer
    on the host fbank and float frames, on the same weights; also on clips
    shorter than the crop, whose padding the frontend zeroes as the host
    does (the JAX package's does not)."""
    over = _cfg(short if clips == "short" else data, str(tmp_path), "eval=True", *LARS)
    dev, host = Trainer(one_rank(over + SHIP), device="cpu"), Trainer(one_rank(over), device="cpu")
    assert dev.needs_device_frontend and not host.needs_device_frontend
    for t in (dev, host):
        t.model.load_state_dict(wav_runs["specaugment_injected"][1].model.state_dict())
    got, want = dev.collect_features(dev.evalloader), host.collect_features(host.evalloader)
    assert got["names"] == want["names"] and len(got["names"]) == 5
    for key in ("x1", "x2"):
        assert got[key].shape == want[key].shape == (5, 32), key
        cos = (got[key] * want[key]).sum(-1) / (np.linalg.norm(got[key], axis=-1)
                                                * np.linalg.norm(want[key], axis=-1))
        assert cos.min() >= 0.9999, (key, cos)
    assert dev.infer(dev.evalloader) == host.infer(host.evalloader)


@pytest.mark.parametrize("train", [False, True])
def test_eval_norms_reads_the_fbanks_the_frontend_makes(data, tmp_path, train):
    """The fbank-statistics job on waveform batches (eval loader, or the
    training loader's placed batches) takes the statistics of the fbanks the
    frontend makes: the host path's, within the fbank tolerance."""
    over = _cfg(data, str(tmp_path), "running.audio.eval_norms=True", "running.audio.transform_fbank=False",
                "running.data_name=val", "running.eval_name=val", *LARS)
    if train:
        over += ["running.eval_name=", "eval=False"]
    got = Trainer(one_rank(over + ["running.audio.on_device=True"]), device="cpu").learn()
    want = Trainer(one_rank(over), device="cpu").learn()
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("fmt", ["ship_bf16", "ship_int16"])
def test_npz_shipping_steps_match_the_jax_trainer(data, tmp_path_factory, fmt):
    jmon, tr, _, _ = _run_both(data, tmp_path_factory, "running.data_name=npz_train",
                               "running.eval_name=", "running.save_epoch=False",
                               "running.audio.transform_fbank=False", f"running.audio.{fmt}=True",
                               *ONE_EPOCH)
    assert tr.needs_device_frontend and not tr.on_device_audio
    np.testing.assert_allclose(_losses(tr.out_dir), _losses(jmon.out_dir), rtol=1e-4)
    _assert_params_match(jmon, tr)


def test_make_batch_keeps_the_ship_dtypes(data, tmp_path):
    tr = Trainer(one_rank(_cfg(data, str(tmp_path), *SHIP)), device="cpu", steps_per_epoch=1)
    arrays = (np.zeros((2, 3, 4, 4), np.uint8), np.zeros((2, 16800), np.int16),
              np.zeros((2, 1, 4, 4), np.uint16), np.zeros((2, 3), np.float64))
    got = tr.make_batch(*arrays)
    assert [t.dtype for t in got] == [torch.uint8, torch.int16, torch.uint16, torch.float32]


def test_la_monitor_runs_unchanged_with_on_device(tmp_path):
    """The audio-text dataset ships fbanks: with ``on_device`` the frontend
    passes them, and the step equals the one without it."""
    make_synth_clotho(str(tmp_path), "clotho_train", n=2, seconds=1.05)
    over = ["+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
            "+model/text=transformer_val", "+model/loss=ce", "+optimizer=standard",
            "+running/audio=default", "worker=CLAP", "monitor=LAMonitor", "compute_dtype=float32",
            "model.audio.width=64", "model.audio.encoder.layers=2", "model.audio.heads=4",
            "model.audio.pre_encoder.stride=[16,24]", "model.text.width=64", "model.text.heads=4",
            "model.text.encoder.layers=2", "running.audio.max_len=100", "running.batch_size=2",
            f"running.data_root={tmp_path}", "running.data_name=clotho_train", "running.eval_name=",
            "running.test_name=", "running.audio.transform_fbank=False", "loader_backend=thread",
            "num_proc=1", "eval=False", f"alias_root={tmp_path}/run", f"model_root={tmp_path}/run",
            "model_file="]
    losses = []
    for extra in ([], ["running.audio.on_device=True"]):
        mon = build_monitor(one_rank(over + extra), device="cpu")
        assert mon.on_device_audio == bool(extra)
        (batch,) = list(mon.loader)  # the epoch run to its end: no item left in flight
        args = mon.device_put.wait(batch)
        assert args[0].dim() == 4  # fbanks, not waveforms
        losses.append(float(mon.train_step(*args)["loss"]))
        mon.close()
    assert losses[0] == losses[1]


def test_an_on_device_resume_is_bitwise_the_uninterrupted_run(data, tmp_path):
    """Two epochs of 2 steps with the device frontend and SpecAugment on:
    saved at step 3 (mid-epoch) and resumed by a fresh trainer, the run ends
    bitwise the uninterrupted one, the masks drawn alike."""
    a = Trainer(one_rank(_resume_cfg(data, str(tmp_path / "a"), 10 ** 9, *SHIP)), device="cpu")
    fresh_rng = a.state.generator.get_state()
    a.learn()
    assert a.on_device_audio and a.global_step == 4
    assert not torch.equal(a.state.generator.get_state(), fresh_rng)  # SpecAugment drew
    run = str(tmp_path / "b")
    Trainer(one_rank(_resume_cfg(data, run, 3, *SHIP)), device="cpu").learn()
    b = Trainer(one_rank(_resume_cfg(data, run, 10 ** 9, *SHIP, "model_file=00000003")), device="cpu")
    assert b.global_step == b.state.step == 3
    b.learn()
    assert b.global_step == 4
    _assert_bitwise(_state(b), _state(a))
