"""The port's data axis (vipant_tpu_torch/parallel, the trainer's mesh, the
engine's ``data_parallel``) against the JAX package on the CPU.

The JAX side runs in this process: ``make_train_step`` on the global batch
on one device (and, for CVAP, on a ``data=2`` mesh of the 8-device virtual
CPU mesh that tests/conftest.py sets up, which gives the same step). The
port's side runs on 2 gloo ranks (tests/torch_dist_worker.py: spawned
processes, one torch thread each, a ``FileStore`` in the test's directory, a
time limit whose expiry fails the test), each on its half of the batch, from
the JAX init.

- Steps (2, B = 8) of CVAP, CLAP retrieval, captioning whose two ranks pad
  their captions differently (``LMLossHead``'s global normaliser), Barlow's
  ``BarlowCELossHead`` (its projector's BatchNorm on the gathered batch):
  each step's loss within rtol 1e-5 of the JAX step's, grad norm within
  1e-4 (1e-3 at the second step), the first step's averaged grads within
  rtol 1e-3 and atol 1e-3 of the largest element, the params within atol
  1e-6 (the updates are ~1e-4), the running statistics within 1e-6, and
  both ranks' params and statistics bitwise equal.
- A ResNet tower's BatchNorm on the global statistics: its training forward
  and backward on 2 ranks against the JAX tower on the whole batch, in
  float64 (see that test).
- SpecAugment and patchout: a 2-rank step on the device frontend with both
  on equals the port's 1-rank step on the global batch (loss rtol 1e-5,
  params atol 1e-6), and each rank's SpecAugment rows are bitwise its slice
  of the global draw.
- ZeRO-1 under LARS and Adam: three steps bitwise the replicated
  optimizer's params and (gathered) state, each rank holding less state, a
  ZeRO save resumed without ZeRO and the reverse bitwise the uninterrupted
  runs.
- A 2-rank VA loop on a synthetic index with a save, an eval and a bitwise
  resume; rank 0's eval report equal to a 1-rank eval of that checkpoint.
- The engine's ``data_parallel`` split over two patched local devices equal
  to one device (atol 1e-6: another batch size per product), and the
  ``token_pack`` guard checking each configured pack where the JAX engine
  checks only the largest (ROADMAP.md queue C, C20).
- The mesh: its four axes laid out as the JAX mesh's devices, the JAX
  asserts, the launchers' environments, the owners of ZeRO's leaves, the
  collectives without a group.
"""

import logging
import os
import sys

import jax
import numpy as np
import pytest
import torch

from vipant_tpu.config import compose as jax_compose
from vipant_tpu.models import build_main_model as jax_build, init_model
from vipant_tpu.models import tunable_mask as jax_tunable_mask
from vipant_tpu.optim import build_optimizer as jax_build_optimizer
from vipant_tpu.optim.partition import merge_params, partition_params as jax_partition
from vipant_tpu.parallel import make_mesh as jax_make_mesh
from vipant_tpu.parallel import replicate as jax_replicate, shard_batch as jax_shard_batch
from vipant_tpu.serve import InferenceEngine as JaxEngine
from vipant_tpu.train import TrainState as JaxState, make_train_step
from vipant_tpu_torch import parallel, serve
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.ops import specaugment
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer

from torch_dist_worker import run_ranks

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the synthetic VA index)

B, SPE = 8, 10
BASE = ["compute_dtype=float32", "optimizer.warmup_epoch=0", f"running.batch_size={B}",
        "model_file="]
VIT = ["+model/image=vit_val", "+model/audio=vit_val", "model.audio.pre_encoder.stride=[16,24]",
       "running.audio.max_len=100", "model.image.width=64", "model.image.embed_dim=32",
       "model.image.encoder.layers=2", "model.image.heads=4"]
TEXT = ["model.text.width=32", "model.text.heads=4", "model.text.encoder.layers=2"]
CVAP = ["+running=bimodal", *VIT, "+model/text=dummy", "+model/loss=ce", "+optimizer=standard",
        "+running/audio=default", "worker=CVAP", *BASE]
CLAP = ["+running=clotho", *VIT, "+model/text=transformer_val", *TEXT, "+model/loss=ce",
        "+optimizer=standard", "+running/audio=default", "worker=CLAP", "monitor=LAMonitor", *BASE]
CAPTION = ["+running=clotho", *VIT, "+model/text=transformer_decoder", "+model/loss=ce_lm",
           "+optimizer=standard", "+running/audio=default", "worker=CLAP", "model.text.width=32",
           "model.text.heads=4", "model.text.layers=2", "model.text.mem_width=64",
           "model.text.max_len_dec=8", "model.text.embed_dim=32", "running.retrieval=False", *BASE]
BARLOW = [o for o in CVAP if o != "+model/loss=ce"] + ["+model/loss=barlow_ce",
                                                       "model.loss.barlow.layers=[24,16,16]"]
JAX_MESH = ["mesh.data=2"]  # the JAX side: B = 8 divides a data axis of 2 (of the 8 devices)


@pytest.fixture
def logged():
    """The messages of the port's logger (which does not propagate to the
    root logger once a trainer has set it up) while the test runs."""
    seen = []
    handler = logging.Handler(logging.DEBUG)
    handler.emit = lambda record: seen.append(record.getMessage())
    log = logging.getLogger("vipant_tpu_torch")
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    yield seen
    log.removeHandler(handler)
    log.setLevel(level)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ids(rng, n, lengths, ctx=77, vocab=49408):
    """Token ids as the tokenizer lays them out (sot, words, eot, zero pad),
    each row's word count drawn from ``lengths``."""
    ids = np.zeros((n, ctx), np.int64)
    for row in ids:
        k = int(rng.integers(*lengths))
        row[0], row[1:1 + k], row[1 + k] = vocab - 2, rng.integers(1, vocab - 2, k), vocab - 1
    return ids


def _inputs(case, cfg):
    r = np.random.default_rng(0)
    res = cfg.model.audio.resolution
    audio = r.standard_normal((B, 1, *res)).astype(np.float32)
    if case in ("clap", "caption"):
        if case == "caption":  # rank 0's captions short, rank 1's long: other pad counts
            text = np.concatenate([_ids(r, B // 2, (2, 4)), _ids(r, B // 2, (9, 13))])
        else:
            text = _ids(r, B, (3, 12))
        return [audio, text]
    ires = cfg.model.image.resolution
    ires = (ires, ires) if isinstance(ires, int) else tuple(ires)
    return [r.standard_normal((B, 3, *ires)).astype(np.float32), audio]


def _unpack_jax_rn(model):
    """The JAX model with its ResNet towers at ``token_pack=0`` (they refuse
    their own default 1: ROADMAP.md queue C, C18)."""
    towers = {t: getattr(model, t).clone(token_pack=0) for t in ("image", "audio")
              if getattr(getattr(model, t, None), "backbone", None) == "resnet"}
    return model.clone(**towers) if towers else model


def jax_steps(over, args, kw=None, steps=2, mesh_data=None):
    """``steps`` JAX steps on the global batch (sharded over a ``data`` mesh
    of ``mesh_data`` devices when given): (init params, init statistics,
    per-step records, the first step's grads by port name)."""
    kw = dict(kw or {})
    cfg = jax_compose(over + JAX_MESH)
    model = _unpack_jax_rn(jax_build(cfg))
    variables = _np(jax.jit(lambda: init_model(cfg, model))())
    params, stats = variables["params"], variables.get("batch_stats")
    trainable, frozen = jax_partition(params, jax_tunable_mask(cfg, params))
    tx, _ = jax_build_optimizer(cfg.optimizer, steps_per_epoch=SPE)

    def adapter(model, variables, batch, rngs):
        return model.apply(variables, *batch, train=True, rngs=rngs,
                           mutable=["batch_stats"] if stats is not None else False, **kw)

    step = make_train_step(model, tx, has_batch_stats=stats is not None, loss_adapter=adapter,
                           donate=False)

    def loss_of(p, f, s, *batch):
        v = {"params": merge_params(p, f)}
        if s is not None:
            v["batch_stats"] = s
        out = model.apply(v, *batch, train=True, mutable=["batch_stats"] if s is not None else False,
                          **kw)
        out = out[0] if s is not None else out
        return out[0] if isinstance(out, tuple) else out

    grads = from_jax.model_state_dict(_np(jax.grad(loss_of)(trainable, frozen, stats, *args)))
    state = JaxState.create(trainable, tx, frozen_params=frozen, batch_stats=stats)
    batch = tuple(args)
    if mesh_data:
        mesh = jax_make_mesh(data=mesh_data)
        with jax.sharding.set_mesh(mesh):
            state = JaxState.create(jax_replicate(trainable, mesh), tx,
                                    frozen_params=jax_replicate(frozen, mesh),
                                    batch_stats=jax_replicate(stats, mesh) if stats else None)
            batch = jax_shard_batch(batch, mesh)
    want = []
    for _ in range(steps):
        state, m = step(state, *batch)
        want.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                         params=from_jax.model_state_dict(_np(state.params)),
                         stats=from_jax.batch_stats_state_dict(_np(state.batch_stats or {}))))
    return params, stats, want, grads


# ------------------------------------------------------------ steps on 2 ranks
STEP_CASES = {"cvap": (CVAP, None), "clap": (CLAP, {"retrieval": True}),
              "caption": (CAPTION, {"retrieval": False}), "barlow": (BARLOW, None)}


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def two_ranks(request, tmp_path_factory):
    case = request.param
    over, kw = STEP_CASES[case]
    args = _inputs(case, jax_compose(over + JAX_MESH))
    params, stats, want, grads = jax_steps(over, args, kw)
    if case == "cvap":  # the JAX step on a data=2 mesh is the one-device step (tests/test_parallel.py)
        _, _, on_mesh, _ = jax_steps(over, args, kw, mesh_data=2)
        for w, m in zip(want, on_mesh):
            assert m["loss"] == pytest.approx(w["loss"], rel=1e-4)
            for k, v in w["params"].items():
                np.testing.assert_allclose(m["params"][k], v, rtol=0, atol=1e-4, err_msg=k)
    got = run_ranks(tmp_path_factory.mktemp(case), "steps",
                    {"overrides": over, "args": args, "params": params, "stats": stats, "spe": SPE})
    return case, want, grads, got, params


@pytest.mark.parametrize("i", range(2))
def test_two_ranks_step_matches_the_jax_global_step(two_ranks, i):
    case, want, _, got, params = two_ranks
    assert [g["mesh"] for g in got] == [(0, 2, "gloo"), (1, 2, "gloo")]
    for g in got:
        s, w = g["steps"][i], want[i]
        assert s["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert s["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4 if i == 0 else 1e-3)
        assert sorted(s["params"]) == sorted(w["params"])
        for k, v in w["params"].items():
            np.testing.assert_allclose(s["params"][k], v, rtol=0, atol=1e-6, err_msg=k)
        assert sorted(s["stats"]) == sorted(w["stats"])
        for k, v in w["stats"].items():
            np.testing.assert_allclose(s["stats"][k], v, rtol=0, atol=1e-6, err_msg=k)
    a, b = (g["steps"][i] for g in got)
    for k in a["params"]:
        assert np.array_equal(a["params"][k], b["params"][k]), k
    for k in a["stats"]:
        assert np.array_equal(a["stats"][k], b["stats"][k]), k
    assert (case == "barlow") == bool(a["stats"])


def test_two_ranks_average_the_jax_grads(two_ranks):
    case, _, grads, got, _ = two_ranks
    for g in got:
        assert sorted(g["grads"]) == sorted(grads)
        for k, w in grads.items():
            np.testing.assert_allclose(g["grads"][k], w, rtol=1e-3,
                                       atol=1e-3 * max(float(np.abs(w).max()), 1e-12), err_msg=k)


@pytest.mark.parametrize("resolution,cin", [((64, 64), 3), ((96, 128), 1)], ids=["image", "audio"])
def test_a_resnet_towers_batchnorm_takes_the_global_statistics(resolution, cin, tmp_path):
    """A ResNet tower's training forward and backward on 2 ranks of 2 items
    against the JAX tower on all 4, both in float64 (batch statistics of a
    few items make these grads ill-conditioned in fp32:
    tests/test_torch_backbones.py): the output and the grads summed over
    the ranks within 1e-5 of their largest element, the moved statistics
    (fp32 variables in flax) within 1e-6 and bitwise equal on both ranks."""
    from vipant_tpu.nn import VisionTower as JaxVisionTower
    import jax.numpy as jnp

    kw = dict(width=16, embed_dim=32, heads=8, layers=(1, 1, 1, 1))
    x = np.random.default_rng(0).standard_normal((4, cin, *resolution)).astype(np.float32)
    cot = np.random.default_rng(2).standard_normal((4, 32))
    jt = JaxVisionTower(resolution=resolution, backbone="resnet", token_pack=0, **kw)
    v = _np(jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    r = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(lambda a: r.uniform(0.5, 1.5, a.shape).astype(np.float32),
                                   v["batch_stats"])
    f64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)
    with jax.enable_x64(True):
        j64 = jt.clone(dtype=jnp.float64, param_dtype=jnp.float64)

        @jax.jit
        def f(p):
            out, mut = j64.apply({"params": p, "batch_stats": f64(stats)},
                                 jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, mut["batch_stats"])

        (_, (want, new_stats)), jgrads = jax.value_and_grad(f, has_aux=True)(f64(v["params"]))
        want, new_stats, jgrads = _np(want), _np(new_stats), _np(jgrads)
    grads = {}
    for path, leaf in from_jax._flat(jgrads):  # the bridge's names and layouts, in float64
        name, fn = from_jax.port_name(path)
        grads[name] = leaf if fn is None else fn(leaf)
    got = run_ranks(tmp_path, "rn_tower", {"resolution": resolution, "kw": kw, "params": v["params"],
                                           "stats": stats, "x": x, "cot": cot})
    top = max(float(np.abs(g).max()) for g in grads.values())
    moved = {k.split(".", 1)[1]: w for k, w in
             from_jax.batch_stats_state_dict({"image": new_stats}).items()}
    for g in got:
        np.testing.assert_allclose(g["out"], want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
        assert sorted(g["grads"]) == sorted(grads)
        for k, w in grads.items():
            # k_proj.bias: zero in exact arithmetic, both are rounding noise
            atol = 1e-7 * top if k == "post_encoder.k_proj.bias" else 1e-5 * np.abs(w).max()
            np.testing.assert_allclose(g["grads"][k], w, rtol=1e-5, atol=atol, err_msg=k)
        assert sorted(g["stats"]) == sorted(moved)
        for k, w in moved.items():
            np.testing.assert_allclose(g["stats"][k], w, rtol=0, atol=1e-6, err_msg=k)
            assert np.array_equal(g["stats"][k], got[0]["stats"][k]), k


# ------------------------------------------------------- the global draws
def test_spec_augment_takes_its_rows_of_the_global_draw():
    feats = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 100, 128)).astype(np.float32))
    whole = specaugment.spec_augment(feats, torch.Generator().manual_seed(5), 32, 50)
    parts = [specaugment.spec_augment(feats[4 * r:4 * (r + 1)], torch.Generator().manual_seed(5),
                                      32, 50, shard=(r, 2)) for r in range(2)]
    assert torch.equal(torch.cat(parts), whole)
    assert not torch.equal(parts[0], specaugment.spec_augment(
        feats[:4], torch.Generator().manual_seed(5), 32, 50))  # a local draw would mask otherwise


def test_two_ranks_draw_specaugment_and_patchout_as_one_rank(tmp_path):
    """A step on the device frontend (waveforms -> fbank -> SpecAugment) with
    patchout, on 2 ranks and on 1, from one init and global batch."""
    over = CVAP + ["running.audio.on_device=True", "model.audio.patchout=0.25",
                   "running.audio.transform_fbank=True"]
    wav = np.random.default_rng(1).standard_normal((B, 16000)).astype(np.float32) * 0.1
    images = np.random.default_rng(2).standard_normal((B, 3, 224, 224)).astype(np.float32)
    got = run_ranks(tmp_path, "steps", {"overrides": over, "args": [images, wav], "spe": SPE})
    tr = Trainer(over, device="cpu", steps_per_epoch=SPE)
    assert tr.needs_device_frontend and tr.model.audio.patchout == 0.25
    batch = tr.make_batch(images, wav)
    for i in range(2):
        m = tr.train_step(*batch)
        for g in got:
            assert g["steps"][i]["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
            for k, p in tr.trainable.items():
                np.testing.assert_allclose(g["steps"][i]["params"][k], p.detach().numpy(), rtol=0,
                                           atol=1e-6, err_msg=k)
            assert torch.equal(g["steps"][i]["generator"], tr.state.generator.get_state())


# ------------------------------------------------------------------ ZeRO-1
@pytest.mark.parametrize("opt", ["lars", "adam"])
def test_zero_matches_the_replicated_optimizer_and_resumes_both_ways(opt, tmp_path):
    over = CVAP + (["optimizer.use_lars=True"] if opt == "lars" else
                   ["optimizer.use_lars=False", "optimizer.warmup=False", "optimizer.lr=1e-3"])
    args = _inputs("cvap", jax_compose(over + JAX_MESH))
    got = run_ranks(tmp_path, "zero", {"overrides": over, "args": args, "root": str(tmp_path)})
    for r, g in enumerate(got):
        for k, v in g[False]["params"].items():
            assert np.array_equal(g[True]["params"][k], v), k
            assert np.array_equal(g[True]["resumed"][k], v), k  # a plain save resumed with ZeRO
            assert np.array_equal(g[False]["resumed"][k], v), k  # a ZeRO save resumed without
        assert g[True]["bytes"] < g[False]["bytes"], (r, g[True]["bytes"], g[False]["bytes"])
    assert got[0][True]["bytes"] + got[1][True]["bytes"] >= got[0][False]["bytes"]
    plain, zero = got[0][False]["opt"], got[0][True]["opt"]  # rank 0 holds the gathered state
    assert plain["count"] == zero["count"] == 3
    assert sorted(plain["inner"]["state"]) == sorted(zero["inner"]["state"])
    for i, st in plain["inner"]["state"].items():
        for key, v in st.items():
            assert torch.equal(zero["inner"]["state"][i][key], v), (i, key)
    for i, st in got[0][True]["resumed_opt"]["inner"]["state"].items():
        for key, v in st.items():
            assert torch.equal(got[0][False]["resumed_opt"]["inner"]["state"][i][key], v), (i, key)


def test_zero_deals_the_large_leaves_by_size():
    sizes = {"a": 1 << 20, "b": 10, "c": 1 << 16, "d": 1 << 17, "e": 1 << 14, "f": 3}
    owners = parallel.assign_owners(sizes, 2)
    assert owners == {"a": 0, "b": None, "c": 1, "d": 1, "e": 1, "f": None}
    assert parallel.assign_owners(sizes, 1) == {k: (0 if v >= 1 << 14 else None)
                                                for k, v in sizes.items()}


# --------------------------------------------------------------- the loop
def test_a_two_rank_loop_saves_evaluates_and_resumes_bitwise(tmp_path):
    data = str(tmp_path / "va")
    chip_smoke.write_synthetic_va(data, "train", 16, seconds=1.05, frame_size=64)
    chip_smoke.write_synthetic_va(data, "val", 8, seconds=1.05, frame_size=64, seed=1)
    over = [o for o in CVAP if not o.startswith("running.batch_size")] + [
        "running.batch_size=4", "running.epochs=2", "running.save_rate=2", "running.peep_rate=1",
        "running.save_epoch=False", "running.eval_samples=0", f"running.data_root={data}",
        "running.data_name=train", "running.eval_name=val", "eval=False", "metrics_jsonl=True",
        "loader_backend=process", "num_proc=2", "optimizer.use_lars=False", "optimizer.warmup=False",
        "optimizer.lr=1e-3", "model_name=run"]
    got = run_ranks(tmp_path, "loop", {"overrides": over, "root": str(tmp_path)}, timeout=300)
    a, b = got
    assert a["step"] == b["step"] == 8 and a["resumed_step"] == 8  # 16 records, 2 ranks of 2 a batch
    for k, v in a["params"].items():
        assert np.array_equal(b["params"][k], v), k  # the replicas stay equal
        assert np.array_equal(a["resumed"][k], v), k  # the resume is the uninterrupted run
    assert [s for s, _ in a["reports"]] == [2, 4, 6, 8] and a["reports"] == b["reports"]
    assert {"train_0.out", "train_1.out", "metrics.jsonl"} <= set(a["logs"])
    # rank 0's report after the first save is a 1-rank eval of that checkpoint
    one = Trainer([o for o in over if not o.startswith(("eval=", "model_name"))]
                  + ["eval=True", "model_name=run", f"model_root={tmp_path}/a",
                     f"model_file={os.path.basename(a['first'])}", f"alias_root={tmp_path}/one"],
                  device="cpu")
    assert one.mesh.data == 1
    assert one.learn() == a["reports"][0][1]
    with open(os.path.join(os.path.dirname(a["first"]), "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 8  # rank 0 alone writes the step rows


# ------------------------------------------------------------- the engine
ENGINE = ["+running=clotho", *VIT, "+model/text=transformer_val", *TEXT, "+model/loss=ce",
          "+running/audio=default", "worker=CLAP", "model_file="]


def test_engine_data_parallel_splits_over_the_local_devices(monkeypatch):
    one = InferenceEngine(ENGINE, batch_size=8, device="cpu")
    monkeypatch.setattr(serve, "_local_devices", lambda device: [torch.device("cpu")] * 2)
    two = InferenceEngine(ENGINE, batch_size=8, device="cpu", data_parallel=True)
    assert len(two.replicas) == 2 and len(one.replicas) == 1
    assert two.replicas[1] is not two.model
    r = np.random.default_rng(0)
    fb = r.standard_normal((11, 100, 128)).astype(np.float32)
    texts = [f"a sound number {i}" for i in range(11)]
    np.testing.assert_allclose(two.embed_audio(fb), one.embed_audio(fb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(two.embed_texts(texts), one.embed_texts(texts), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="does not split"):
        InferenceEngine(ENGINE, batch_size=7, device="cpu", data_parallel=True)


def test_token_pack_guard_checks_every_configured_pack(monkeypatch):
    """B = 48 over 8 devices (6 a replica), image pack 6, text pack 4: the
    JAX engine checks only the largest pack, (48 // 6) % 8 == 0, and builds
    an engine whose text tower cannot pack its 6 rows in 4s; the port checks
    each pack and refuses the text tower's."""
    over = ["+running=bimodal", *VIT, "+model/text=transformer_val", *TEXT, "+model/loss=ce",
            "+running/audio=default", "worker=CLVP", "model_file=", "model.image.token_pack=6", "model.text.token_pack=4"]
    jeng = JaxEngine(over, batch_size=48, data_parallel=True)  # builds: the C20 fault
    assert jeng.mesh is not None and int(jeng.mesh.shape["data"]) == jax.device_count() == 8
    monkeypatch.setattr(serve, "_local_devices", lambda device: [torch.device("cpu")] * 8)
    with pytest.raises(ValueError, match="model.text.token_pack=4"):
        InferenceEngine(over, batch_size=48, device="cpu", data_parallel=True)
    eng = InferenceEngine(over[:-1] + ["model.text.token_pack=6"], batch_size=48, device="cpu",
                          data_parallel=True)  # both packs fit the 6 rows of a replica
    assert len(eng.replicas) == 8


def test_engine_drops_its_own_pack_where_a_replica_cannot_hold_it(monkeypatch, logged):
    monkeypatch.setattr(serve, "_local_devices", lambda device: [torch.device("cpu")] * 2)
    eng = InferenceEngine(ENGINE, batch_size=4, device="cpu", data_parallel=True, token_pack=4,
                          echo=logging.getLogger("vipant_tpu_torch"))
    assert eng.model.text.token_pack == 1 and any("packing disabled" in m for m in logged)


# --------------------------------------------------------------- the mesh
LAUNCHER_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "NUM_PROCESSES",
                 "PROCESS_ID", "COORDINATOR_ADDRESS")


def test_the_mesh_lays_out_four_axes_and_reads_the_launchers(monkeypatch):
    """Rank r sits at the JAX mesh's coordinate of device r (``reshape(data,
    model, pipe, seq)``, data-major); each axis's group lists the ranks that
    differ only on it; the JAX asserts (pipe with seq, seq with model) and
    the world's size hold before any group forms."""
    mesh = jax_make_mesh(data=2, model=2, pipe=1, seq=2)
    sizes = {"data": 2, "model": 2, "pipe": 1, "seq": 2}
    ids = [d.id for d in jax.devices()[:8]]
    for r in range(8):
        c = parallel.mesh.coords_of(r, sizes)
        assert mesh.devices[c["data"], c["model"], c["pipe"], c["seq"]].id == ids[r]
        for axis in ("data", "model", "seq"):
            group = parallel.mesh.axis_ranks(r, sizes, axis)
            assert r in group and len(group) == 2
            assert all(parallel.mesh.coords_of(q, sizes)[a] == c[a]
                       for q in group for a in sizes if a != axis)
            assert [parallel.mesh.coords_of(q, sizes)[axis] for q in group] == [0, 1]
    m = parallel.Mesh(2, 5, "gloo", model=2, seq=2)
    assert (m.data_index, m.index("model"), m.index("seq"), m.world) == (1, 0, 1, 8)
    assert parallel.data_shard_info(m) == (1, 2)
    with pytest.raises(ValueError, match="mesh.pipe and mesh.seq cannot combine"):
        parallel.make_mesh(pipe=2, seq=2)
    with pytest.raises(ValueError, match="seq and model"):
        parallel.make_mesh(model=2, seq=2)
    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    assert parallel.launcher_env() is None
    m = parallel.make_mesh()
    assert (m.data, m.rank, m.backend, m.distributed, m.parallel) == (1, 0, None, False, False)
    assert parallel.make_mesh(data=1).data == 1
    with pytest.raises(ValueError, match=r"mesh.data=2 must equal the number of ranks \(1\)"):
        parallel.make_mesh(data=2)  # without a launcher the world is one rank: nothing falls back
    with pytest.raises(ValueError, match="1 ranks do not divide into model=2"):
        parallel.make_mesh(model=2)
    monkeypatch.setenv("NUM_PROCESSES", "1")  # the JAX launcher forms no group of one
    assert parallel.launcher_env() is None
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)  # its processes fill the cards
    assert parallel.launcher_env() == {"world": 4, "rank": 3, "local_rank": 1,
                                       "init_method": "tcp://10.0.0.1:1234"}
    monkeypatch.setenv("WORLD_SIZE", "2")  # torchrun's names win
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert parallel.launcher_env() == {"world": 2, "rank": 1, "local_rank": 1,
                                       "init_method": "tcp://127.0.0.1:29500"}
    assert parallel.launcher_device("cuda") == torch.device("cuda", 1)
    assert parallel.launcher_device("cuda:0") == torch.device("cuda", 0)
    assert parallel.launcher_device("cpu") == torch.device("cpu")


def test_each_rank_sets_its_card_before_the_group_forms(monkeypatch):
    """Under torchrun a rank's current device is ``cuda:{LOCAL_RANK}`` before
    its group forms, so that NCCL's collectives and the rank's CUDA context
    sit on its own card and not on card 0."""
    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(WORLD_SIZE="2", RANK="1", LOCAL_RANK="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="29500").items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", torch.device(d))))
    monkeypatch.setattr(parallel.mesh, "distributed_init",
                        lambda device: calls.append(("group", device)) or False)
    parallel.make_mesh(device=parallel.launcher_device("cuda"))
    assert calls == [("set_device", torch.device("cuda", 1)), ("group", torch.device("cuda", 1))]
    calls.clear()
    parallel.make_mesh(device="cpu")
    assert calls == [("group", torch.device("cpu"))]


def test_the_collectives_without_a_group_change_nothing():
    x = torch.arange(6.0).reshape(3, 2)
    assert parallel.gather_batch(x, None) is x and parallel.all_reduce_sum(x, None) is x
    one = parallel.Mesh()
    assert parallel.gather_batch(x, one) is x
    g = {"a": x, "b": torch.ones(2)}
    assert parallel.all_reduce_grads(g, one) == g
    assert parallel.data_shard_info(None) == (0, 1) and parallel.data_shard_info(one) == (0, 1)
    two = parallel.Mesh(2, 1, "gloo")
    assert parallel.data_shard_info(two) == (1, 2)
    rows = parallel.shard_batch((np.arange(8).reshape(4, 2), None), two)
    assert torch.equal(rows[0], torch.tensor([[4, 5], [6, 7]])) and rows[1] is None
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch(np.zeros((3, 1)), two)


# ------------------------------------------------------------ the launchers
@pytest.mark.parametrize("script,run_type", [("run_bimodal_va.sh", "bimodal"),
                                             ("run_bimodal_at.sh", "trimodal")])
def test_the_launchers_run_torchrun_with_nproc(script, run_type, tmp_path):
    """``NPROC`` > 1: bash/torch/*.sh run ``torchrun --nproc_per_node=$NPROC
    -m vipant_tpu_torch`` with the overrides they pass to ``python`` without
    it (a ``torchrun`` and a ``python`` on PATH that record their arguments)."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def launch(**env):
        for tool in ("python", "torchrun"):
            fake = tmp_path / tool
            fake.write_text(f'#!/bin/sh\nprintf "{tool}\\n" > "$ARGS_OUT"\nprintf "%s\\n" "$@" >> "$ARGS_OUT"\n')
            fake.chmod(0o755)
        out = tmp_path / "args.txt"
        subprocess.run(["sh", os.path.join(root, "bash", "torch", script), run_type, "platform=cpu"],
                       env=dict(os.environ, PATH=f"{tmp_path}:{os.environ['PATH']}", ARGS_OUT=str(out),
                                **env), check=True, cwd=str(tmp_path), timeout=30)
        return out.read_text().split()

    one, two = launch(), launch(NPROC="2")
    assert one[:3] == ["python", "-m", "vipant_tpu_torch"] and "mesh.data=-1" in one
    assert two[:4] == ["torchrun", "--nproc_per_node=2", "-m", "vipant_tpu_torch"]
    assert two[4:] == one[3:]


def test_the_command_line_trains_two_ranks_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc_per_node=2 -m vipant_tpu_torch ...
    platform=cpu``: two gloo ranks (the group formed from torchrun's
    environment) train a tiny AT step on a synthetic Clotho index of 4 clips,
    2 a rank, each rank logging to its own file and rank 0 writing the
    checkpoint and the metrics."""
    import json
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = tmp_path / "data"
    chip_smoke.write_synthetic_clotho(str(data), "clotho_train", 4, seconds=1.05)
    args = ["+running=clotho", *VIT, "+model/text=transformer_val", *TEXT, "+model/loss=ce",
            "+optimizer=standard", "+running/audio=default", "worker=CLAP", "monitor=LAMonitor",
            "platform=cpu", "mesh.data=-1", f"running.data_root={data}",
            "running.data_name=clotho_train", "running.eval_name=", "running.test_name=",
            "running.batch_size=4", "running.epochs=1", "running.save_epoch=True",
            "running.peep_rate=1", "eval=False", "loader_backend=thread", "num_proc=1",
            "metrics_jsonl=True", "model_name=tr", f"alias_root={tmp_path}/run",
            f"model_root={tmp_path}/run", "model_file="]
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node=2", "-m", "vipant_tpu_torch", *args],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    run = tmp_path / "run" / "tr"
    assert sorted(os.listdir(run / "00000001")) == ["COMMITTED", "config.json", "model.npz", "state.pt"]
    assert "mesh {'data': 2, 'model': 1, 'pipe': 1, 'seq': 1}, rank 0 (gloo)" in proc.stdout
    assert "rank 1" not in proc.stdout  # rank 0 alone logs to the console
    for r in (0, 1):
        assert "epoch 0 step 1 loss" in (run / f"train_{r}.out").read_text()
    with open(run / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1]
