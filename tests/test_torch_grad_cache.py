"""The port's gradient cache (vipant_tpu_torch/parallel/grad_cache.py,
``train.step.grad_cache_step``, the trainer's ``running.grad_cache``)
against the JAX package's ``make_grad_cache_step`` and against the plain
step, on the CPU in fp32 at B = 8 in 4 chunks (``chunk_size=2``).

- VA (CVAP: the image tower frozen, encoded once) and AT (CLAP retrieval),
  two steps from one JAX init: each step's loss within rtol 1e-5 of the JAX
  gradient-cache step's, grad norm within 1e-4 (1e-3 at the second step),
  the params within atol 1e-6 (the updates are ~1e-4), as
  tests/test_torch_train.py holds the plain step; and the same against the
  port's plain step on the whole batch. With patchout the port takes the
  JAX chunks' index sets (recorded from ``jax.random.permutation``: flax
  folds the module path into the key), in the order the JAX step draws
  them: each chunk's embedding pass, then each chunk's re-forward.
- Each chunk's draws replay in its re-forward and differ across chunks; the
  generator ends where the embedding pass left it.
- On 2 gloo ranks (tests/torch_dist_worker.py), each rank's 4 rows in 4
  chunks, the embeddings gathered before the loss: the JAX step's numbers
  with the same tolerances, both ranks' params bitwise equal.
- The JAX trainer's chunk-count rule; the refusal of models with running
  statistics (``batch_stats``), the captioning bypass, the monitors without
  two streams.
"""

import contextlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from vipant_tpu.config import compose as jax_compose
from vipant_tpu.models import build_main_model as jax_build, init_model
from vipant_tpu.models import tunable_mask as jax_tunable_mask
from vipant_tpu.optim import build_optimizer as jax_build_optimizer
from vipant_tpu.optim.partition import partition_params as jax_partition
from vipant_tpu.train import TrainState as JaxState
from vipant_tpu.train.step import make_grad_cache_step
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.parallel import chunk_count
from vipant_tpu_torch.train import build_monitor

from torch_dist_worker import run_ranks

B, SPE, CHUNKS = 8, 10, 4
BASE = ["compute_dtype=float32", "optimizer.warmup_epoch=0", f"running.batch_size={B}",
        "model_file=", "+optimizer=standard", "+running/audio=default"]
VIT = ["+model/image=vit_val", "+model/audio=vit_val", "model.audio.pre_encoder.stride=[16,24]",
       "running.audio.max_len=100", "model.image.width=64", "model.image.embed_dim=32",
       "model.image.encoder.layers=2", "model.image.heads=4"]
VA = ["+running=bimodal", *VIT, "+model/text=dummy", "+model/loss=ce", "worker=CVAP", *BASE]
AT = ["+running=clotho", *VIT, "+model/text=transformer_val", "model.text.width=32",
      "model.text.heads=4", "model.text.encoder.layers=2", "+model/loss=ce", "worker=CLAP",
      "monitor=LAMonitor", *BASE]
GC = ["running.grad_cache.alive=True", "running.grad_cache.chunk_size=2"]
CASES = {"va": (VA, ("encode_image", "encode_audio")),
         "at": (AT, ("encode_audio", "encode_text")),
         "va_patchout": (VA + ["model.audio.patchout=0.25"], ("encode_image", "encode_audio"))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@contextlib.contextmanager
def recorded_permutations(seen):
    """``jax.random.permutation`` as it is, each result also appended to
    ``seen`` when it is computed (inside the jitted step too)."""
    draw = jax.random.permutation

    def recorded(key, x, *args, **kw):
        out = draw(key, x, *args, **kw)
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), out, ordered=True)
        return out

    with mock.patch.object(jax.random, "permutation", recorded):
        yield
    jax.effects_barrier()


def _keep_set(perm, p):
    return np.sort(perm[:max(int(perm.shape[0] * (1.0 - p)), 1)]) + 1


def _inputs(case):
    r = np.random.default_rng(0)
    audio = r.standard_normal((B, 1, 100, 128)).astype(np.float32)
    if case == "at":
        ids = np.zeros((B, 77), np.int64)
        for row in ids:
            k = int(r.integers(3, 12))
            row[0], row[1:1 + k], row[1 + k] = 49406, r.integers(1, 49406, k), 49407
        return [audio, ids]
    return [r.standard_normal((B, 3, 224, 224)).astype(np.float32), audio]


def jax_gc_steps(over, methods, args, steps=2):
    """Two JAX gradient-cache steps on one device: (init params, records,
    the patchout index sets in the order they were drawn)."""
    cfg = jax_compose(over + ["mesh.data=2"])
    model = jax_build(cfg)
    params = _np(jax.jit(lambda: init_model(cfg, model))())["params"]
    trainable, frozen = jax_partition(params, jax_tunable_mask(cfg, params))
    tx, _ = jax_build_optimizer(cfg.optimizer, steps_per_epoch=SPE)
    state = JaxState.create(trainable, tx, frozen_params=frozen)
    step = make_grad_cache_step(model, tx, CHUNKS, *methods)
    seen, want = [], []
    with recorded_permutations(seen):
        for _ in range(steps):
            state, m = step(state, *args)
            want.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                             params=from_jax.model_state_dict(_np(state.params))))
    return params, want, [_keep_set(p, 0.25) for p in seen]


def _check(got, want, i):
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4 if i == 0 else 1e-3)
    assert sorted(got["params"]) == sorted(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=1e-6, err_msg=k)


def _port_steps(over, params, args, steps=2, index_sets=None):
    tr = build_monitor(over, device="cpu", steps_per_epoch=SPE)
    from_jax.load_params(tr.model, params)
    if index_sets is not None:
        queue = list(index_sets)
        tr.model.audio.patchout_indices = lambda n, keep, device: torch.as_tensor(queue.pop(0))
    batch = tr.make_batch(*args)
    out = []
    for _ in range(steps):
        m = tr.train_step(*batch)
        out.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                        params={k: p.detach().numpy().copy() for k, p in tr.trainable.items()}))
    if index_sets is not None:
        assert not queue
    return tr, out


@pytest.fixture(scope="module", params=sorted(CASES))
def gc_runs(request):
    case = request.param
    over, methods = CASES[case]
    args = _inputs(case)
    params, want, sets = jax_gc_steps(over, methods, args)
    patchout = case.endswith("patchout")
    # each step: the 4 audio chunks' draws in the embedding pass, then in the re-forward
    assert len(sets) == (2 * 2 * CHUNKS if patchout else 0)
    tr, got = _port_steps(over + GC, params, args, index_sets=sets if patchout else None)
    assert tr.grad_cache == (methods, CHUNKS)
    plain = _port_steps(over, params, args)[1]
    # with patchout each chunk draws its own subset; in one chunk the draw is the plain step's
    one = _port_steps(over + GC + [f"running.grad_cache.chunk_size={B}"], params, args)
    assert one[0].grad_cache == (methods, 1)
    return dict(want=want, got=got, plain=plain, against_plain=one[1] if patchout else got)


@pytest.mark.parametrize("i", range(2))
def test_the_grad_cache_step_matches_the_jax_grad_cache_step(gc_runs, i):
    _check(gc_runs["got"][i], gc_runs["want"][i], i)


@pytest.mark.parametrize("i", range(2))
def test_the_grad_cache_step_matches_the_plain_step(gc_runs, i):
    """4 chunks against the plain step; with patchout, 1 chunk (each chunk
    draws its own subset, so only one chunk draws the plain step's)."""
    _check(gc_runs["against_plain"][i], gc_runs["plain"][i], i)


def test_each_chunk_replays_its_draws_in_the_re_forward():
    tr = build_monitor(VA + GC + ["model.audio.patchout=0.25"], device="cpu", steps_per_epoch=SPE)
    draws = []
    tower = tr.model.audio
    plain_draw = tower.patchout_indices
    tower.patchout_indices = lambda n, keep, device: (lambda i: (draws.append(i), i)[1])(
        plain_draw(n, keep, device))
    batch = tr.make_batch(*_inputs("va"))
    start = tr.state.generator.get_state()
    tr.train_step(*batch)
    assert len(draws) == 2 * CHUNKS
    first, again = draws[:CHUNKS], draws[CHUNKS:]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert len({tuple(d.tolist()) for d in first}) == CHUNKS
    g = torch.Generator().manual_seed(0)
    g.set_state(start)
    n = tr.model.audio.grid[0] * tr.model.audio.grid[1]
    for _ in range(CHUNKS):  # the generator ends after the embedding pass's draws
        torch.randperm(n, generator=g)
    assert torch.equal(g.get_state(), tr.state.generator.get_state())


def test_the_grad_cache_on_two_ranks_matches_the_jax_step(tmp_path):
    over, methods = CASES["va"]
    args = _inputs("va")
    params, want, _ = jax_gc_steps(over, methods, args)
    got = run_ranks(tmp_path, "steps", {"overrides": over + GC, "args": args, "params": params,
                                        "spe": SPE})
    for g in got:
        assert g["grad_cache"] == (methods, CHUNKS) and g["mesh"][1] == 2
        for i in range(2):
            _check(g["steps"][i], want[i], i)
    for k, v in got[0]["steps"][1]["params"].items():
        assert np.array_equal(got[1]["steps"][1]["params"][k], v), k


@pytest.mark.parametrize("batch,chunk,ranks,want", [
    (8, 128, 1, 1), (256, 64, 1, 4), (250, 128, 1, 2), (50, 16, 1, 5), (49, 16, 1, 7),
    (8, 3, 1, 4), (8, 3, 2, 4), (12, 4, 2, 3), (432, 128, 4, 4), (10, 5, 2, None), (9, 9, 2, None)])
def test_the_chunk_count_follows_the_jax_rule(batch, chunk, ranks, want):
    """The smallest count whose chunks hold at most ``chunk`` items and
    divide the batch (``vipant_tpu/train/trainer.py:369-374``); each rank's
    share must split into as many."""
    if want is None:
        with pytest.raises(ValueError, match="do not split"):
            chunk_count(batch, chunk, ranks)
    else:
        assert chunk_count(batch, chunk, ranks) == want


def test_the_grad_cache_refuses_batch_stats_and_skips_captioning(capsys):
    barlow = [o for o in VA if o != "+model/loss=ce"] + ["+model/loss=barlow_ce",
                                                          "model.loss.barlow.layers=[24,16,16]"]
    with pytest.raises(ValueError, match="batch_stats"):
        build_monitor(barlow + GC, device="cpu", steps_per_epoch=SPE)
    caption = ["+running=clotho", *VIT, "+model/text=transformer_decoder", "+model/loss=ce_lm",
               "worker=CLAP", "monitor=LAMonitor", "model.text.width=32", "model.text.heads=4",
               "model.text.layers=2", "model.text.mem_width=64", "model.text.max_len_dec=8",
               "model.text.embed_dim=32", "running.retrieval=False", *BASE]
    tr = build_monitor(caption + GC, device="cpu", steps_per_epoch=SPE)
    # the trainer's logger writes to the console (it replaces its handlers when set up)
    assert tr.grad_cache is None and "gradient cache ignored" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no gradient cache"):
        build_monitor(VA + GC + ["monitor=VASMonitor", "running.multi_view=True"], device="cpu",
                      steps_per_epoch=SPE)
