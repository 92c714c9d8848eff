"""The port's VA training step (vipant_tpu_torch/train) against the JAX
package's ``make_train_step`` on the tiny flagship config
(``__graft_entry__._flagship_cfg(tiny=True)``: frozen ViT image tower and
trainable audio tower, width 64, 2 layers, CELossHead, LARS with clipping
at 0.5), both started from one JAX init carried over by the bridge
(vipant_tpu_torch/ckpt/from_jax.py), on one seeded batch of 8.

``optimizer.warmup_epoch=0`` so the LARS rate is non-zero at step 0. In
fp32 loss and grad_norm agree to rtol 1e-5, every trainable grad by name to
rtol = 1e-3 with atol = 1e-3 * max |grad| (different fp32 summation
orders), and the updated params to atol 1e-6 (the updates themselves are
~1e-4). In bf16 the JAX model runs its XLA path on the CPU, which rounds
biases differently from the Pallas kernels the port follows (see
tests/test_torch_serve.py), so grads and updates are held to cosine >= 0.99.
"""

import jax
import numpy as np
import pytest
import torch

from vipant_tpu.config import compose
from vipant_tpu.models import build_main_model as jax_build, init_model
from vipant_tpu.models import tunable_mask as jax_tunable_mask
from vipant_tpu.optim import build_optimizer as jax_build_optimizer
from vipant_tpu.optim.partition import merge_params, partition_params as jax_partition
from vipant_tpu.train import TrainState as JaxState, make_train_step
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.models import build_main_model, tunable_mask
from vipant_tpu_torch.train import Trainer, apply_gradients, loss_and_grads, train_step

FLAGSHIP_TINY = [
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "worker=CVAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4",
]
B, STEPS, SPE = 8, 2, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is fastest, and keeps
    this file from oversubscribing the cores when the suite runs in
    several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dtype, *extra):
    return compose(FLAGSHIP_TINY + [f"compute_dtype={dtype}", "optimizer.warmup_epoch=0",
                                    f"running.batch_size={B}", *extra])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_init():
    cfg = _cfg("float32")
    return init_model(cfg, jax_build(cfg))["params"]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def runs(request, jax_init):
    """Two steps on the same batch in JAX and in the port from one init:
    (dtype, per-step JAX records, per-step port records, init, port)."""
    dtype = request.param
    cfg = _cfg(dtype)
    r = np.random.default_rng(0)
    images = r.standard_normal((B, 3, 224, 224)).astype(np.float32)
    audios = r.standard_normal((B, 1, 100, 128)).astype(np.float32)

    model = jax_build(cfg)
    trainable, frozen = jax_partition(jax_init, jax_tunable_mask(cfg, jax_init))
    tx, _ = jax_build_optimizer(cfg.optimizer, steps_per_epoch=SPE)
    state = JaxState.create(trainable, tx, frozen_params=frozen)
    step = make_train_step(model, tx, donate=False)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, f, i, a: model.apply({"params": merge_params(p, f)}, i, a, train=True)))
    want = []
    for _ in range(STEPS):
        _, grads = grad_fn(state.params, state.frozen_params, images, audios)
        state, m = step(state, images, audios)
        want.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                         grads=from_jax.model_state_dict(_np(grads)),
                         params=from_jax.model_state_dict(_np(state.params))))

    tr = Trainer(cfg, device="cpu", steps_per_epoch=SPE)
    from_jax.load_params(tr.model, jax_init)
    init = {k: v.detach().clone() for k, v in tr.model.named_parameters()}
    batch = tr.make_batch(images, audios)
    got = []
    for i in range(STEPS):
        if i == 0:  # the step in its two halves, to read the grads
            loss, grads = loss_and_grads(tr.state, *batch)
            m = {"loss": loss, **apply_gradients(tr.state, grads)}
        else:
            grads = loss_and_grads(tr.state, *batch)[1]
            m = tr.train_step(*batch)
        got.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), lr=m["lr"],
                        grads={k: g.float().numpy() for k, g in grads.items()},
                        params={k: p.detach().numpy().copy() for k, p in tr.trainable.items()}))
    return dtype, want, got, init, tr


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("i", range(STEPS))
def test_loss_and_grad_norm_match_jax(runs, i):
    dtype, want, got, _, _ = runs
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got[i]["loss"] == pytest.approx(want[i]["loss"], rel=tol)
    assert got[i]["grad_norm"] == pytest.approx(want[i]["grad_norm"], rel=tol if i == 0 else 10 * tol)
    assert got[i]["lr"] == pytest.approx(B / 256)  # LARS base rate, no warmup


@pytest.mark.parametrize("i", range(STEPS))
def test_every_trainable_grad_matches_jax(runs, i):
    dtype, want, got, _, tr = runs
    assert sorted(got[i]["grads"]) == sorted(want[i]["grads"]) == sorted(tr.trainable)
    for k, w in want[i]["grads"].items():
        g = got[i]["grads"][k]
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * np.abs(w).max(), err_msg=k)
        elif np.abs(w).max() > 0:
            assert _cos(g, w) >= 0.99, k


@pytest.mark.parametrize("i", range(STEPS))
def test_updated_params_match_jax(runs, i):
    dtype, want, got, init, _ = runs
    for k, w in want[i]["params"].items():
        g, p0 = got[i]["params"][k], init[k].numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        # the update, where fp32 resolves it (LayerNorm gains move ~1e-7)
        if np.abs(w - p0).max() > 1e3 * np.spacing(np.abs(p0).max()):
            assert _cos(g - p0, w - p0) >= (0.999 if dtype == "float32" else 0.99), k


def test_frozen_image_tower_is_untouched(runs):
    _, _, _, init, tr = runs
    assert tr.frozen and all(k.startswith("image.") for k in tr.frozen)
    assert all(k.startswith(("audio.", "loss.")) for k in tr.trainable)
    for k, p in tr.frozen.items():
        assert not p.requires_grad and p.grad is None
        assert torch.equal(p.detach(), init[k]), k
    assert not any(p.grad is not None for p in tr.model.parameters())
    assert tr.state.step == STEPS and tr.state.optimizer.count == STEPS
    opt_params = {id(p) for g in tr.state.optimizer.inner.param_groups for p in g["params"]}
    assert opt_params == {id(p) for p in tr.trainable.values()}


@pytest.mark.parametrize("extra", [
    [],
    ["model.image.freeze=False", "model.audio.freeze=True"],
    ["running.excl_modules.amodules=[pre_encoder,misc]", "running.excl_modules.vmodules=[post]"],
    ["worker=CLAP", "+model/text=transformer_val", "model.text.width=32", "model.text.heads=4",
     "model.text.encoder.layers=2", "model.text.freeze=True"],
], ids=["flagship", "image_trained", "excl_modules", "clap"])
def test_tunable_mask_matches_jax(extra):
    over = [o for o in FLAGSHIP_TINY if not (extra and extra[0] == "worker=CLAP"
                                             and o in ("worker=CVAP", "+model/text=dummy"))]
    cfg = compose(over + list(extra))
    model = jax_build(cfg)
    params = jax.eval_shape(lambda: init_model(cfg, model))["params"]
    want = from_jax.model_state_dict(jax_tunable_mask(cfg, params), convert=False)
    got = tunable_mask(cfg, build_main_model(cfg))
    assert got == {k: bool(v) for k, v in want.items()}
    assert any(got.values()) and not all(got.values())


def test_cvap_overfits_eight_pairs_with_adam():
    """8 fixed (image, audio) pairs, the Adam path at lr 4e-3: the
    symmetric InfoNCE falls below 0.3x its start (cf. tests/test_learning.py,
    here without the loader)."""
    cfg = compose(FLAGSHIP_TINY + ["optimizer.use_lars=False", "optimizer.warmup=False",
                                   "optimizer.lr=4.0e-3", "running.batch_size=8",
                                   "compute_dtype=float32"])
    tr = Trainer(cfg, device="cpu")
    r = np.random.default_rng(1)
    batch = tr.make_batch(r.standard_normal((8, 3, 224, 224)).astype(np.float32),
                          r.standard_normal((8, 1, 100, 128)).astype(np.float32))
    losses = [float(tr.train_step(*batch)["loss"]) for _ in range(40)]
    assert np.isfinite(losses).all()
    assert losses[0] > 3.0, losses[0]
    assert np.mean(losses[-3:]) < 0.3 * losses[0], losses


def test_trainer_refuses_what_is_not_ported():
    for extra in (["running.audio.on_device=True", "running.audio.dither=1.0"],
                  ["running.audio.on_device=True", "running.audio.use_energy=True"]):
        with pytest.raises(NotImplementedError):
            Trainer(_cfg("float32", *extra), device="cpu")
    for axis in ("model", "pipe", "seq"):  # ported: one process has no second rank to split over
        with pytest.raises(ValueError, match=f"1 ranks do not divide into model={2 if axis == 'model' else 1}"):
            Trainer(_cfg("float32", f"mesh.{axis}=2"), device="cpu")
    assert Trainer(_cfg("float32", "running.multi_view=True"), device="cpu")  # ported: builds
    assert Trainer(_cfg("float32", "async_ckpt=True"), device="cpu")
    assert Trainer(_cfg("float32", "running.grad_cache.alive=True"), device="cpu").grad_cache
    assert Trainer(_cfg("float32", "mesh.zero=True"), device="cpu")  # one rank: nothing to split
    for missing in ("model_file=ckpt", "model_file=x.pth"):  # a configured checkpoint that is not there
        with pytest.raises(FileNotFoundError):
            Trainer(_cfg("float32", missing), device="cpu")
    with pytest.raises(ValueError, match="data_name"):
        Trainer(_cfg("float32", "eval=False", "running.data_name=", "running.eval_name="),
                device="cpu").learn()


def test_state_dict_round_trips_through_torch_save(tmp_path):
    tr = Trainer(_cfg("float32"), device="cpu")
    r = np.random.default_rng(2)
    batch = tr.make_batch(r.standard_normal((B, 3, 224, 224)).astype(np.float32),
                          r.standard_normal((B, 1, 100, 128)).astype(np.float32))
    train_step(tr.state, *batch)
    torch.save(tr.state.state_dict(), tmp_path / "state.pt")
    sd = torch.load(tmp_path / "state.pt")
    assert sd["step"] == 1 and sd["opt_state"]["count"] == 1
    assert set(sd["params"]) == set(tr.trainable) and set(sd["frozen_params"]) == set(tr.frozen)
    tr2 = Trainer(_cfg("float32"), device="cpu")
    tr2.state.optimizer.load_state_dict(sd["opt_state"])
    assert tr2.state.optimizer.count == 1
