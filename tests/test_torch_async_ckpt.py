"""Asynchronous checkpoints of the port (vipant_tpu_torch/train/checkpoint.py,
``async_save=True``; the trainer's ``async_ckpt``), on the CPU at the tiny
flagship config of tests/test_torch_train.py:

- retention counts committed step directories only, so with ``keep_last=1``
  the newest committed one survives beside the one in flight (the rule
  tests/test_review_fixes.py holds the JAX package's Orbax saves to);
- every save, ``load_checkpoint`` and ``latest_checkpoint`` wait for the
  save in flight; a writer's error is raised by the next wait, never
  swallowed;
- the files an async save writes are bitwise the sync save's from the same
  state, though the state moves on right after the call;
- ``Trainer.learn`` with ``async_ckpt=True`` waits at its end, and a run
  resumed from its async save is bitwise the run resumed from a sync save.
"""

import filecmp
import os
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from vipant_tpu_torch.train import Trainer, checkpoint, train_step
from vipant_tpu_torch.train.checkpoint import (is_committed, latest_checkpoint, load_checkpoint,
                                               save_checkpoint, wait_for_saves)

TINY = [
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "worker=CVAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "compute_dtype=float32", "optimizer.warmup_epoch=0", "model_file=",
]
FILES = ("state.pt", "config.json", "model.npz", "COMMITTED")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_save_in_flight():
    yield
    wait_for_saves()


@pytest.fixture(scope="module")
def trainer():
    tr = Trainer(TINY, device="cpu", steps_per_epoch=10)
    r = np.random.default_rng(0)
    tr.batch = tr.make_batch(r.standard_normal((4, 3, 224, 224)).astype(np.float32),
                             r.standard_normal((4, 1, 100, 128)).astype(np.float32))
    return tr


def _save(tr, root, step, **kw):
    return save_checkpoint(str(root), step, tr.state, cfg=tr.cfg,
                           model_only=tr.collect_model_export(), **kw)


def _steps(root):
    return sorted(d for d in os.listdir(root) if d.isdigit())


def test_retention_never_deletes_the_last_committed(trainer, tmp_path):
    for step in (1, 2, 3):
        _save(trainer, tmp_path, step, keep_last=1, async_save=True)
        present = _steps(tmp_path)
        assert f"{step:08d}" in present
        if step > 1:
            assert f"{step - 1:08d}" in present, present
        if step > 2:
            assert f"{step - 2:08d}" not in present, present
    wait_for_saves()
    assert all(is_committed(os.path.join(tmp_path, d)) for d in _steps(tmp_path))
    _save(trainer, tmp_path, 4, keep_last=1)  # a sync save keeps N in all
    assert _steps(tmp_path) == ["00000004"]


def test_saves_and_reads_wait_for_the_save_in_flight(trainer, tmp_path, monkeypatch):
    gate = threading.Event()
    write = torch.save

    def slow_save(obj, f, *a, **kw):
        gate.wait(10)
        return write(obj, f, *a, **kw)

    monkeypatch.setattr(checkpoint.torch, "save", slow_save)
    path = _save(trainer, tmp_path, 1, async_save=True)
    assert not is_committed(path) and checkpoint._PENDING is not None
    threading.Timer(0.2, gate.set).start()
    assert latest_checkpoint(str(tmp_path)) == path  # waited: committed now
    assert checkpoint._PENDING is None
    gate.clear()
    _save(trainer, tmp_path, 2, async_save=True)
    threading.Timer(0.2, gate.set).start()
    load_checkpoint(path, trainer.state)  # waits for step 2 too
    assert is_committed(os.path.join(tmp_path, "00000002"))


def test_a_writer_error_surfaces_at_the_next_wait(trainer, tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.np, "savez", broken)
    path = _save(trainer, tmp_path, 1, async_save=True)  # returns: the error is in the thread
    with pytest.raises(RuntimeError, match="disk full"):
        wait_for_saves()
    assert not is_committed(path)
    wait_for_saves()  # raised once, then cleared
    _save(trainer, tmp_path, 2, async_save=True)
    with pytest.raises(RuntimeError, match="disk full"):
        _save(trainer, tmp_path, 3)  # a new save waits first, and raises


def test_async_files_are_the_sync_files_though_the_state_moves_on(trainer, tmp_path):
    train_step(trainer.state, *trainer.batch)
    trainer.global_step = trainer.state.step
    sync = _save(trainer, tmp_path / "sync", 5)
    asyn = _save(trainer, tmp_path / "async", 5, async_save=True)
    train_step(trainer.state, *trainer.batch)  # moves every trainable tensor in place
    wait_for_saves()
    for name in FILES:
        assert filecmp.cmp(os.path.join(sync, name), os.path.join(asyn, name), shallow=False), name
    a = torch.load(os.path.join(sync, "state.pt"), weights_only=True)
    assert all(not torch.equal(a["params"][k], p) for k, p in trainer.state.trainable.items()
               if k.startswith("audio.encoder"))


def _loop(tmp_path, name, *extra):
    root = tmp_path / "data"
    if not (root / "train.jsonl").exists():
        for split, n in (("train", 8), ("val", 4)):
            chip_smoke.write_synthetic_va(str(root), split, n, seconds=1.05, frame_size=64)
    run = tmp_path / name
    return [*TINY, f"alias_root={run}", f"model_root={run}", "model_name=loop",
            f"running.data_root={root}", "running.data_name=train", "running.eval_name=val",
            "running.batch_size=4", "running.epochs=2", "running.save_rate=1000000000",
            "running.save_epoch=True", "running.peep_rate=1", "eval=False", "seed=3",
            "loader_backend=thread", "num_proc=1", *extra]  # one worker: the same batches each run


def test_learn_waits_and_a_resume_from_an_async_save_is_the_sync_runs(tmp_path):
    runs = {}
    for mode in ("sync", "async"):
        over = _loop(tmp_path, mode, f"async_ckpt={mode == 'async'}", "running.epochs=1")
        Trainer(over, device="cpu").learn()
        assert checkpoint._PENDING is None  # learn waited
        step_dir = latest_checkpoint(str(tmp_path / mode / "loop"))
        assert step_dir is not None and os.path.basename(step_dir) == "00000002"
        resumed = Trainer([o for o in over if o not in ("model_file=", "running.epochs=1")]
                          + ["model_file=00000002"], device="cpu")
        resumed.learn()
        runs[mode] = {k: p.detach().clone() for k, p in resumed.model.named_parameters()}
        assert resumed.state.step == 4
    for k, p in runs["sync"].items():
        assert torch.equal(p, runs["async"][k]), k
