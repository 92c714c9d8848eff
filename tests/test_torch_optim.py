"""The port's optimizers (vipant_tpu_torch/optim) against the JAX package's
(vipant_tpu/optim) on the same numpy params and grads over several steps:
the schedules, LARS's groups and update, optax's global-norm clipping and
the Adam path, mirroring tests/test_lars_semantics.py and tests/test_optim.py.

The params are laid out as the two packages hold them: the port's torch
names and layouts ([out, in] dense weights, [3C, C] qkv) against the JAX
package's flax keys and layouts ([in, out], [C, 3, C]); LARS's trust ratio
does not depend on the layout. Updated params agree to rtol = 1e-5,
atol = 1e-6 (fp32, different summation orders in the norms)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vipant_tpu.config import Config
from vipant_tpu.optim import build_optimizer as jax_build_optimizer
from vipant_tpu.optim import lars as jax_lars
from vipant_tpu.optim import warmup_cosine_lr as jax_cosine_lr
from vipant_tpu.optim import warmup_multistep_lr as jax_multistep_lr
from vipant_tpu_torch.optim import (
    LARS, Optimizer, build_optimizer, clip_by_global_norm, global_norm, partition_params,
    warmup_cosine_lr, warmup_multistep_lr)

C = 8
# port name -> (JAX path, port layout -> JAX layout)
LAYOUT = {
    "dense.weight": (("dense", "kernel"), lambda a: a.T),
    "dense.bias": (("dense", "bias"), None),
    "attn.in_proj_weight": (("qkv", "kernel"), lambda a: a.T.reshape(C, 3, C)),
    "attn.in_proj_bias": (("qkv", "bias"), lambda a: a.reshape(3, C)),
    "ln.weight": (("ln", "scale"), None),
    "ln.bias": (("ln", "bias"), None),
    "misc.class_embedding": (("misc", "class_embedding"), None),
    "misc.positional_embedding": (("misc", "positional_embedding"), None),
    "loss.logit_scale": (("loss", "logit_scale"), None),
    "zero.weight": (("zero", "kernel"), lambda a: a.T),
}
SHAPES = {"dense.weight": (4, C), "dense.bias": (4,), "attn.in_proj_weight": (3 * C, C),
          "attn.in_proj_bias": (3 * C,), "ln.weight": (C,), "ln.bias": (C,),
          "misc.class_embedding": (C,), "misc.positional_embedding": (5, C),
          "loss.logit_scale": (), "zero.weight": (3, 3)}
WEIGHTS = {"dense.weight", "attn.in_proj_weight", "misc.positional_embedding", "zero.weight"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is fastest, and keeps
    this file from oversubscribing the cores when the suite runs in
    several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _to_jax(flat):
    tree = {}
    for k, a in flat.items():
        (outer, inner), fn = LAYOUT[k]
        a = np.asarray(a, np.float32)
        tree.setdefault(outer, {})[inner] = jnp.asarray(fn(a) if fn else a)
    return tree


def _params():
    """Seeded params; ``zero.weight`` is all zeros, so LARS takes q = 1 for it."""
    arrays = _arrays(0)
    arrays["zero.weight"][:] = 0
    return {k: torch.nn.Parameter(torch.from_numpy(a)) for k, a in arrays.items()}


def _grads(step):
    return {k: torch.from_numpy(a) for k, a in _arrays(100 + step).items()}


def _assert_same(params, tree):
    for k, p in params.items():
        want = _to_jax({k: p.detach().numpy()})
        (outer, inner), _ = LAYOUT[k]
        np.testing.assert_allclose(np.asarray(want[outer][inner]), np.asarray(tree[outer][inner]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _jax_run(tx, steps):
    params = _to_jax({k: p.detach().numpy() for k, p in _params().items()})
    state = tx.init(params)
    for i in range(steps):
        grads = _to_jax({k: g.numpy() for k, g in _grads(i).items()})
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return params


@pytest.mark.parametrize("total,warmup", [(100, 10), (50, 0), (30, 30)])
def test_cosine_schedule_matches_jax(total, warmup):
    want = jax_cosine_lr(1.7, total, warmup)
    got = warmup_cosine_lr(1.7, total, warmup)
    for step in (0, 1, 5, warmup, warmup + 1, total // 2, total - 1, total, total + 1, 3 * total):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-7), step
    # clamped past the end: the rate stays at its floor instead of climbing back
    assert got(3 * total) == pytest.approx(1.7 * 1e-3)


@pytest.mark.parametrize("warmup,milestones", [(5, (10, 20)), (1, ()), (4, (3,))])
def test_multistep_schedule_matches_jax(warmup, milestones):
    want = jax_multistep_lr(0.5, warmup, milestones, gamma=0.5)
    got = warmup_multistep_lr(0.5, warmup, milestones, gamma=0.5)
    for step in range(30):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6), step
    assert got(0) == pytest.approx(min(0.5 / warmup, 0.5))  # step + 1: non-zero at step 0


def test_lars_groups_follow_the_jax_rule():
    params = _params()
    opt = LARS(params.items())
    names = {id(p): k for k, p in params.items()}
    groups = {g["weight"]: {names[id(p)] for p in g["params"]} for g in opt.param_groups}
    assert groups[True] == WEIGHTS
    assert groups[False] == set(SHAPES) - WEIGHTS  # LN, class_embedding, qkv bias, logit_scale


@pytest.mark.parametrize("steps", [1, 3])
def test_lars_matches_jax(steps):
    kw = dict(lr_weight=0.2, lr_bias=0.0048, momentum=0.9, eta=0.001, weight_decay=1e-6)
    want = _jax_run(jax_lars(lambda step: jnp.asarray(0.7), **kw), steps)
    params = _params()
    opt = LARS(params.items(), **kw)
    for i in range(steps):
        for group in opt.param_groups:
            group["lr"] = 0.7
        for k, g in _grads(i).items():
            params[k].grad = g
        opt.step()
    _assert_same(params, want)
    assert params["zero.weight"].detach().abs().max() > 0  # a zero weight takes q = 1


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    grads = [g * scale for g in _grads(0).values()]
    norm = float(global_norm(grads))
    want, _ = optax.clip_by_global_norm(5.0).update([jnp.asarray(g.numpy()) for g in grads],
                                                    optax.EmptyState())
    got = clip_by_global_norm(grads, 5.0)
    assert (norm < 5.0) == (scale == 0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    assert float(optax.global_norm([jnp.asarray(g.numpy()) for g in grads])) == pytest.approx(norm)


def _opt_cfg(**kw):
    base = dict(use_lars=True, name="Adam", warmup=True, warmup_steps=2, warmup_epoch=1, lr=1e-2,
                weight_decay=1e-2, betas=[0.9, 0.99], max_norm=3.0, lr_weight=0.2,
                lr_bias=0.0048, eta=0.001, batch_size=256, epochs=4, steps=[], gamma=0.5)
    base.update(kw)
    return Config(base)


@pytest.mark.parametrize("cfg", [
    dict(),                                  # LARS, warmup over warmup_epoch, clipped
    dict(warmup=False, max_norm=None),       # LARS warms up even with warmup=False
    dict(use_lars=False),                    # Adam, warmup and decoupled decay
    dict(use_lars=False, warmup=False, steps=[1], weight_decay=0.0),  # Adam, multistep
], ids=["lars", "lars_nowarmup", "adam", "adam_multistep"])
def test_build_optimizer_matches_jax(cfg):
    spe, steps = 2, 5
    tx, schedule = jax_build_optimizer(_opt_cfg(**cfg), steps_per_epoch=spe)
    want = _jax_run(tx, steps)
    params = _params()
    opt = build_optimizer(_opt_cfg(**cfg), spe, params)
    assert isinstance(opt.inner, LARS if cfg.get("use_lars", True) else torch.optim.AdamW)
    lrs = [opt.apply(_grads(i))["lr"] for i in range(steps)]
    for i, lr in enumerate(lrs):
        assert lr == pytest.approx(float(schedule(i)), rel=1e-6, abs=1e-9)
    if cfg.get("use_lars", True):
        assert lrs[0] == 0.0  # the LARS rate at step 0 with warmup
    _assert_same(params, want)
    assert opt.count == steps and all(p.grad is None for p in params.values())


def test_adam_path_is_decoupled_weight_decay():
    """The Adam path's decay is lr-scaled and outside the moments: it is
    AdamW, not Adam(weight_decay=...), which folds the decay into the grad."""
    params = _params()
    opt = build_optimizer(_opt_cfg(use_lars=False, warmup=False, weight_decay=0.5, max_norm=None),
                          1, params)
    ref = {k: torch.nn.Parameter(p.detach().clone()) for k, p in params.items()}
    coupled = torch.optim.Adam(list(ref.values()), lr=1e-2, betas=(0.9, 0.99), weight_decay=0.5)
    opt.apply(_grads(0))
    for k, g in _grads(0).items():
        ref[k].grad = g
    coupled.step()
    assert not torch.allclose(params["dense.weight"], ref["dense.weight"])


def test_partition_params_freezes_by_mask():
    model = torch.nn.Sequential(torch.nn.Linear(2, 3), torch.nn.Linear(3, 1))
    mask = {"0.weight": False, "0.bias": False, "1.weight": True, "1.bias": True}
    trainable, frozen = partition_params(model, mask)
    assert set(trainable) == {"1.weight", "1.bias"} and set(frozen) == {"0.weight", "0.bias"}
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())
    with pytest.raises(ValueError, match="disagree"):
        partition_params(model, {"0.weight": True})
    opt = Optimizer(trainable, LARS(trainable.items()), lambda step: 0.1)
    assert opt.state_dict()["count"] == 0
