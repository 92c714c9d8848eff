"""The port's other backbones and patchout against the JAX package on the
CPU: the ResNet tower (vipant_tpu_torch/nn/resnet.py), the DeiT tower
(nn/deit.py), their porters (ckpt/clip_port.py ``port_clip_resnet``,
ckpt/deit_port.py), their weight bridge (ckpt/from_jax.py), patchout in
training (nn/heads.py), the meme / CLIP / checkpoint init priority
(train/trainer.py ``load_meme``) and the engine's running statistics.

Sizes are small: ResNet width 16 with one block a stage (pool width 512, 8
heads) on 64 x 64 images and 96 x 128 log-mels; DeiT width 64, 2 layers, 4
heads on 32 x 32 images and 64 x 128 log-mels (patch 16, stride 10 x 10).
The JAX ResNet tower refuses its own default ``token_pack=1``
(``vipant_tpu/nn/heads.py:125-127``; ROADMAP.md queue C), so its towers are
built here with ``token_pack=0``, which changes nothing else.

Tolerances: a tower's eval output to 1e-5 and a porter's tensors bitwise,
or to 1e-5 where a grid is re-gridded (``F.interpolate`` against
``jax.image.resize``); the ResNet tower's training-mode output and grads in
float64 to 1e-5 of their largest element (see that test); DeiT grads in
fp32 to rtol 1e-3 with atol 1e-3 of the largest element; running
statistics to 1e-6; a VA step's loss and grad norm to rtol 1e-5 (1e-4 and
1e-3 for the grad norm of the first and second step), its updated params
to atol 1e-6 (the updates are ~1e-4), as tests/test_torch_train.py holds
the ViT step, and the ResNet step's to 3e-5 and cosine 0.999 of each
update.
"""

import contextlib
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipant_tpu.ckpt import clip_port as jax_clip_port
from vipant_tpu.ckpt.deit_port import port_deit as jax_port_deit
from vipant_tpu.config import compose as jax_compose
from vipant_tpu.models import build_main_model as jax_build, init_model
from vipant_tpu.models import tunable_mask as jax_tunable_mask
from vipant_tpu.nn import VisionTower as JaxVisionTower
from vipant_tpu.nn.deit import DeiTTower as JaxDeiTTower
from vipant_tpu.optim import build_optimizer as jax_build_optimizer
from vipant_tpu.optim.partition import partition_params as jax_partition
from vipant_tpu.train import TrainState as JaxState, make_train_step
from vipant_tpu_torch.ckpt import clip_port, from_jax
from vipant_tpu_torch.ckpt.deit_port import port_deit
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.models import build_main_model, tunable_mask
from vipant_tpu_torch.nn.deit import DeiTTower
from vipant_tpu_torch.nn.heads import VisionTower, build_audio_head, build_image_head
from vipant_tpu_torch.nn.resnet import ResNetTower
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer

from torch_oracle_resnet import OracleModifiedResNet

RN_KW = dict(width=16, embed_dim=32, heads=8, layers=(1, 1, 1, 1))
BASE = ["+running=bimodal", "+model/text=dummy", "+model/loss=ce", "+optimizer=standard",
        "+running/audio=default", "worker=CVAP", "compute_dtype=float32",
        "optimizer.warmup_epoch=0", "model_file="]
RN_TINY = BASE + [
    "+model/image=rn50_val", "+model/audio=rn50_val", "model.image.width=16",
    "model.image.embed_dim=32", "model.image.encoder.layers=[1,1,1,1]", "model.image.heads=8",
    "model.audio.heads=8", "model.image.resolution=64", "running.audio.max_len=96",
]
DEIT_TINY = BASE + [
    "+model/image=deit", "+model/audio=deit", "model.image.resolution=32",
    "model.image.embed_dim=32", "running.audio.max_len=64",
    *[f"model.{t}.{k}={v}" for t in ("image", "audio")
      for k, v in (("width", 64), ("layers", 2), ("heads", 4))],
]
FLAGSHIP_TINY = BASE + [
    "+model/image=vit_val", "+model/audio=vit_val", "model.audio.pre_encoder.stride=[16,24]",
    "running.audio.max_len=100", "model.image.width=64", "model.image.embed_dim=32",
    "model.image.encoder.layers=2", "model.image.heads=4",
]
SPE = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3,
                               atol=1e-3 * max(float(np.abs(want).max()), 1e-12), err_msg=err_msg)


def _jax_rn(resolution):
    return JaxVisionTower(resolution=resolution, backbone="resnet", token_pack=0, **RN_KW)


def _unpack_jax_rn(model):
    """A JAX model built from a config, its ResNet towers without the
    ``token_pack`` they refuse."""
    towers = {t: getattr(model, t).clone(token_pack=0) for t in ("image", "audio")
              if getattr(getattr(model, t), "backbone", None) == "resnet"}
    return model.clone(**towers) if towers else model


def _load_tower(tower, params, stats=None):
    sd = {k: torch.tensor(v) for k, v in from_jax.tower_state_dict(params).items()}
    if stats is not None:
        sd.update({k.split(".", 1)[1]: torch.tensor(v)
                   for k, v in from_jax.batch_stats_state_dict({"image": stats}).items()})
    tower.load_state_dict(sd, strict=True)


def _tower_stats(tower):
    return {k: b.numpy() for k, b in tower.named_buffers()}


def _jax_stats(stats):
    return {k.split(".", 1)[1]: v for k, v in from_jax.batch_stats_state_dict({"image": stats}).items()}


# ------------------------------------------------------------------- ResNet
@pytest.fixture(scope="module", params=[((64, 64), 3), ((96, 128), 1)], ids=["image", "audio"])
def rn(request):
    """A JAX ResNet tower and the port's from one init, the running
    statistics drawn away from (0, 1) so that eval mode reads them."""
    resolution, cin = request.param
    x = np.random.default_rng(0).standard_normal((3, cin, *resolution)).astype(np.float32)
    jt = _jax_rn(resolution)
    v = _np(jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    r = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(lambda a: r.uniform(0.5, 1.5, a.shape).astype(np.float32),
                                   v["batch_stats"])
    pt = ResNetTower(resolution=resolution, **RN_KW)
    _load_tower(pt, v["params"], stats)
    return jt, pt, v["params"], stats, x


def test_resnet_tower_eval_matches_jax(rn):
    jt, pt, params, stats, x = rn
    want = jax.jit(functools.partial(jt.apply, train=False))({"params": params, "batch_stats": stats},
                                                            jnp.asarray(x))
    before = _tower_stats(pt)
    with torch.no_grad():
        got = pt(torch.tensor(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert all(np.array_equal(before[k], v) for k, v in _tower_stats(pt).items())


def test_resnet_tower_train_output_statistics_and_grads_match_jax(rn):
    """In float64 on both sides: normalising by the statistics of a few
    items makes these grads ill-conditioned (fp32 against fp64 of the same
    port tower: 29 % on a layer-3 weight at 64 x 64), so fp32 would hold
    neither package to the other. The pool's softmax stays fp32 in both
    (as the JAX module has it), so output and grads are held to 1e-5 of
    their largest element, the moved statistics (fp32 variables in flax)
    to 1e-6."""
    jt, pt, params, stats, x = rn
    cot = np.random.default_rng(2).standard_normal((x.shape[0], 32))
    f64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)
    with jax.enable_x64(True):
        jt = jt.clone(dtype=jnp.float64, param_dtype=jnp.float64)

        @jax.jit
        def f(p):
            out, mut = jt.apply({"params": p, "batch_stats": f64(stats)}, jnp.asarray(x, jnp.float64),
                                train=True, mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, mut["batch_stats"])

        (_, (want, new_stats)), jgrads = jax.value_and_grad(f, has_aux=True)(f64(params))
        want, new_stats, jgrads = _np(want), _np(new_stats), _np(jgrads)
    tower = ResNetTower(resolution=pt.resolution, dtype=torch.float64, **RN_KW)
    _load_tower(tower, params, stats)
    tower.double()
    out = tower(torch.tensor(x, dtype=torch.float64), train=True)
    (out * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    for k, w in _jax_stats(new_stats).items():
        # flax stores the moved statistics in their fp32 variables
        np.testing.assert_allclose(_tower_stats(tower)[k], w, rtol=0, atol=1e-6, err_msg=k)
    grads = {}
    for path, leaf in from_jax._flat(jgrads):  # the bridge's names and layouts, kept in float64
        name, fn = from_jax.port_name(path)
        grads[name] = leaf if fn is None else fn(leaf)
    assert sorted(grads) == sorted(k for k, _ in tower.named_parameters())
    top = max(float(np.abs(g).max()) for g in grads.values())
    for k, p in tower.named_parameters():
        # k_proj.bias: zero in exact arithmetic, both are rounding noise
        atol = 1e-7 * top if k == "post_encoder.k_proj.bias" else 1e-5 * np.abs(grads[k]).max()
        np.testing.assert_allclose(p.grad.numpy(), grads[k], rtol=1e-5, atol=atol, err_msg=k)


def test_resnet_names_round_trip_through_the_bridge(rn):
    _, pt, params, stats, _ = rn
    back = from_jax.to_jax_params({f"audio.{k}": p for k, p in pt.named_parameters()},
                                  resnet_towers=["audio"])["audio"]
    flat, want = dict(from_jax._flat(back)), dict(from_jax._flat(params))
    assert sorted(flat) == sorted(want)
    assert all(np.array_equal(flat[k], np.asarray(want[k])) for k in want)
    stats_back = from_jax.to_jax_batch_stats({f"audio.{k}": b for k, b in pt.named_buffers()})
    assert dict(from_jax._flat(stats_back["audio"])).keys() == dict(from_jax._flat(stats)).keys()


def test_resnet_refuses_the_vit_knobs_and_require_feature():
    base = compose(RN_TINY)
    for knob, value in (("patchout", 0.25), ("token_pack", 4), ("int8_frozen", True)):
        cfg = compose(RN_TINY + [f"model.image.{knob}={value}"])
        with pytest.raises(ValueError, match=knob):
            build_image_head(cfg.model.image)
    tower = build_image_head(base.model.image)
    assert isinstance(tower, ResNetTower) and tower.grid == (2, 2)
    assert build_audio_head(base.model.audio).grid == (3, 4)
    with pytest.raises(NotImplementedError, match="ViT-only"):
        tower(torch.zeros(2, 3, 64, 64), require_feature=True)


def _oracle(resolution=64):
    torch.manual_seed(0)
    oracle = OracleModifiedResNet(layers=(1, 1, 1, 1), width=16, embed_dim=32,
                                  resolution=resolution, heads=8).eval()
    with torch.no_grad():
        for m in oracle.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.7, 1.3)
    return oracle


@pytest.mark.parametrize("resolution", [(64, 64), (96, 128)], ids=["same_grid", "regridded"])
def test_clip_resnet_porter_matches_the_jax_porter(resolution):
    """Every tensor the file's bitwise but the re-gridded pool grid (1e-5
    against the JAX porter's); on CLIP's own grid the tower computes the
    oracle's forward (1e-5)."""
    oracle = _oracle()
    sd = {k: v for k, v in oracle.state_dict().items()}
    pt = ResNetTower(resolution=resolution, **RN_KW)
    got = clip_port.port_clip_visual(sd, pt)
    want = jax_clip_port.port_clip_visual(sd, _jax_rn(resolution))
    want_sd = {**from_jax.tower_state_dict(want["params"]), **_jax_stats(want["batch_stats"])}
    assert sorted(got) == sorted(want_sd) == sorted([*dict(pt.named_parameters()),
                                                      *dict(pt.named_buffers())])
    for k, w in want_sd.items():
        if k == "post_encoder.positional_embedding":
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-5)
        else:
            assert np.array_equal(got[k].numpy(), w), k
    pt.load_state_dict(got)
    if resolution == (64, 64):
        x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 64, 64)).astype(np.float32))
        with torch.no_grad():
            np.testing.assert_allclose(pt(x).numpy(), oracle(x).numpy(), rtol=0, atol=1e-5)


def test_a_vit_tower_refuses_resnet_weights_and_back():
    sd = _oracle().state_dict()
    vit = VisionTower(width=64, embed_dim=32, resolution=64, heads=4, layers=1, patch_size=32)
    with pytest.raises(ValueError, match="ResNet"):
        clip_port.port_clip_visual(sd, vit)
    with pytest.raises(ValueError, match="ViT"):
        clip_port.port_clip_visual({"conv1.weight": torch.zeros(64, 3, 32, 32)},
                                   ResNetTower(resolution=64, **RN_KW))


# --------------------------------------------------------------------- DeiT
DEIT_TOWERS = {
    "image": dict(resolution=32, stride=None, in_channels=3),
    "audio": dict(resolution=(64, 128), stride=(10, 10), in_channels=1),
}


@pytest.fixture(scope="module", params=sorted(DEIT_TOWERS))
def deit(request):
    kw = dict(width=64, embed_dim=32, patch_size=16, heads=4, layers=2, **DEIT_TOWERS[request.param])
    res = kw["resolution"]
    x = np.random.default_rng(0).standard_normal(
        (3, kw["in_channels"], *((res, res) if isinstance(res, int) else res))).astype(np.float32)
    jt = JaxDeiTTower(**kw)
    params = _np(jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    pt = DeiTTower(**kw)
    _load_tower(pt, params)
    return request.param, jt, pt, params, x


def test_deit_tower_forward_and_grads_match_jax(deit):
    _, jt, pt, params, x = deit
    cot = np.random.default_rng(2).standard_normal((x.shape[0], 32)).astype(np.float32)
    f = lambda p: jnp.sum(jt.apply({"params": p}, jnp.asarray(x)) * cot)
    want, jgrads = jax.jit(jax.value_and_grad(f))(params)
    out = pt(torch.tensor(x), train=True)
    loss = (out * torch.tensor(cot)).sum()
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-4 * max(1.0, abs(float(want)))
    grads = from_jax.tower_state_dict(_np(jgrads))
    for k, p in pt.named_parameters():
        _close(p.grad.numpy(), grads[k], err_msg=k)
    assert all(b.mlp.act == "gelu" and not b.mlp.clip_init for b in pt.blocks.resblocks)
    assert pt.norm.eps == 1e-5  # the JAX package's, not timm's 1e-6 (ROADMAP.md queue C)


def test_deit_names_round_trip_through_the_bridge(deit):
    _, _, pt, params, _ = deit
    back = from_jax.to_jax_params({f"image.{k}": p for k, p in pt.named_parameters()})["image"]
    flat, want = dict(from_jax._flat(back)), dict(from_jax._flat(params))
    assert sorted(flat) == sorted(want)
    assert all(np.array_equal(flat[k], np.asarray(want[k])) for k in want)


def timm_deit_state_dict(width=64, layers=2, grid=196, classes=1000, seed=0):
    """A seeded state dict in timm's ``deit_base_distilled_patch16_224``
    layout at ``width`` and ``layers``."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g)
    sd = {"pos_embed": rn(1, grid + 2, width), "cls_token": rn(1, 1, width),
          "dist_token": rn(1, 1, width), "patch_embed.proj.weight": rn(width, 3, 16, 16),
          "patch_embed.proj.bias": rn(width), "norm.weight": 1 + 0.1 * rn(width),
          "norm.bias": rn(width), "head.weight": rn(classes, width), "head.bias": rn(classes),
          "head_dist.weight": rn(classes, width), "head_dist.bias": rn(classes)}
    for i in range(layers):
        for name, shape in (("attn.qkv.weight", (3 * width, width)), ("attn.qkv.bias", (3 * width,)),
                            ("attn.proj.weight", (width, width)), ("attn.proj.bias", (width,)),
                            ("norm1.weight", (width,)), ("norm1.bias", (width,)),
                            ("norm2.weight", (width,)), ("norm2.bias", (width,)),
                            ("mlp.fc1.weight", (4 * width, width)), ("mlp.fc1.bias", (4 * width,)),
                            ("mlp.fc2.weight", (width, 4 * width)), ("mlp.fc2.bias", (width,))):
            sd[f"blocks.{i}.{name}"] = 0.05 * rn(*shape)
    return sd


@pytest.mark.parametrize("embed_dim", [32, 1000], ids=["seeded_heads", "file_heads"])
def test_port_deit_matches_the_jax_porter(deit, embed_dim):
    """Re-gridded positions and the resized (and, for the log-mel tower,
    channel-collapsed) patch kernel to 1e-5; every other tensor bitwise,
    the heads the file's when they fit and the JAX porter's seeded draw
    otherwise."""
    which, _, _, _, _ = deit
    kw = dict(width=64, embed_dim=embed_dim, patch_size=16, heads=4, layers=2, **DEIT_TOWERS[which])
    sd = timm_deit_state_dict()
    pt = DeiTTower(**kw)
    got = port_deit(sd, pt)
    want = from_jax.tower_state_dict(jax_port_deit(sd, JaxDeiTTower(**kw))["params"])
    assert sorted(got) == sorted(want) == sorted(k for k, _ in pt.named_parameters())
    for k, w in want.items():
        if k in ("pos_embed", "patch_embed.weight"):
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-5, err_msg=k)
        else:
            assert np.array_equal(got[k].numpy(), w), k
    assert np.array_equal(got["head"].numpy(), sd["head.weight"].numpy().T) == (embed_dim == 1000)
    pt.load_state_dict(got)


@contextlib.contextmanager
def recorded_permutations(seen):
    """``jax.random.permutation`` as it is, each result also appended to
    ``seen`` when it is computed (inside a jitted step too): the JAX
    tower's patchout draw, whose key flax derives from the step's."""
    draw = jax.random.permutation

    def recorded(key, x, *args, **kw):
        out = draw(key, x, *args, **kw)
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), out)
        return out

    with mock.patch.object(jax.random, "permutation", recorded):
        yield
    jax.effects_barrier()


def _keep_set(perm, p):
    n = perm.shape[0]
    return np.sort(perm[:max(int(n * (1.0 - p)), 1)]) + 1


# ---------------------------------------------------------------- VA steps
STEPS = {"rn50": RN_TINY, "deit": DEIT_TINY,
         "patchout": FLAGSHIP_TINY + ["model.audio.patchout=0.25"]}
B = 4


def _va_inputs(cfg, seed=0):
    r = np.random.default_rng(seed)
    res = cfg.model.image.resolution
    res = (res, res) if isinstance(res, int) else tuple(res)
    images = r.standard_normal((B, 3, *res)).astype(np.float32)
    audios = r.standard_normal((B, 1, *cfg.model.audio.resolution)).astype(np.float32)
    return images, audios


@pytest.fixture(scope="module", params=sorted(STEPS))
def steps(request):
    """Two steps on one batch in JAX (``make_train_step``) and in the port
    from one init; with patchout the port takes the JAX step's index sets
    (``jax.random.permutation`` of ``fold_in(rng, 1)``)."""
    which = request.param
    jcfg, cfg = jax_compose(STEPS[which]), compose(STEPS[which])
    images, audios = _va_inputs(jcfg)
    model = _unpack_jax_rn(jax_build(jcfg))
    variables = _np(jax.jit(lambda: init_model(jcfg, model))())  # one program: eager init takes 4x
    stats = variables.get("batch_stats")
    trainable, frozen = jax_partition(variables["params"], jax_tunable_mask(jcfg, variables["params"]))
    tx, _ = jax_build_optimizer(jcfg.optimizer, steps_per_epoch=SPE)
    state = JaxState.create(trainable, tx, frozen_params=frozen, batch_stats=stats)
    step = make_train_step(model, tx, has_batch_stats=stats is not None, donate=False)
    seen, want = [], []
    with recorded_permutations(seen):
        for _ in range(2):
            state, m = step(state, images, audios)
            want.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                             params=from_jax.model_state_dict(_np(state.params)),
                             stats=from_jax.batch_stats_state_dict(_np(state.batch_stats or {}))))
    idx = [_keep_set(perm, 0.25) for perm in seen]
    assert len(idx) == (2 if which == "patchout" else 0)
    tr = Trainer(cfg, device="cpu", steps_per_epoch=SPE)
    from_jax.load_params(tr.model, variables["params"])
    if stats is not None:
        from_jax.load_batch_stats(tr.model, stats)
    if which == "patchout":
        queue = list(idx)
        tr.model.audio.patchout_indices = lambda n, keep, device: torch.as_tensor(queue.pop(0))
    init = {k: v.detach().clone() for k, v in tr.model.named_parameters()}
    batch = tr.make_batch(images, audios)
    got = []
    for _ in range(2):
        m = tr.train_step(*batch)
        got.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                        params={k: p.detach().numpy().copy() for k, p in tr.trainable.items()},
                        stats={k: b.numpy().copy() for k, b in tr.model.named_buffers()}))
    return which, want, got, init, tr, jcfg


@pytest.mark.parametrize("i", range(2))
def test_va_step_matches_the_jax_step(steps, i):
    which, want, got, init, tr, _ = steps
    assert got[i]["loss"] == pytest.approx(want[i]["loss"], rel=1e-5)
    assert got[i]["grad_norm"] == pytest.approx(want[i]["grad_norm"], rel=1e-4 if i == 0 else 1e-3)
    assert sorted(got[i]["params"]) == sorted(want[i]["params"])
    for k, w in want[i]["params"].items():
        # the ResNet step's grads pass through the batch statistics of 4 items (see
        # test_resnet_tower_train_output_statistics_and_grads_match_jax): its updates,
        # ~1e-4, are held to 3e-5 and, where they are no rounding noise, to cosine 0.999
        atol = 3e-5 if which == "rn50" else 1e-6
        np.testing.assert_allclose(got[i]["params"][k], w, rtol=0, atol=atol, err_msg=k)
        p0 = init[k].numpy()
        if which == "rn50" and np.abs(w - p0).max() > 1e-8:
            d, e = (got[i]["params"][k] - p0).ravel(), (w - p0).ravel()
            assert d @ e / (np.linalg.norm(d) * np.linalg.norm(e)) >= 0.999, k
    assert sorted(got[i]["stats"]) == sorted(want[i]["stats"])
    for k, w in want[i]["stats"].items():
        np.testing.assert_allclose(got[i]["stats"][k], w, rtol=0, atol=1e-6, err_msg=k)


def test_the_step_moves_a_frozen_resnet_towers_statistics_as_jax_does(steps):
    """The JAX step applies every tower with ``train=True`` and a mutable
    ``batch_stats``: the frozen image tower normalises by the batch and its
    running statistics move, while its parameters do not (ROADMAP.md queue
    C)."""
    which, want, got, init, tr, jcfg = steps
    assert tr.frozen and all(k.startswith("image.") for k in tr.frozen)
    for k, p in tr.frozen.items():
        assert torch.equal(p.detach(), init[k]), k
    if which == "rn50":
        moved = [k for k in want[1]["stats"] if k.startswith("image.")]
        assert moved and all(not np.allclose(got[1]["stats"][k], want[0]["stats"][k]) or
                             k.endswith("var") for k in moved if k.endswith("mean"))
        mask = from_jax.model_state_dict(jax_tunable_mask(jcfg, from_jax.jax_params_of(tr.model)),
                                         convert=False)
        assert tunable_mask(jcfg, tr.model) == {k: bool(v) for k, v in mask.items()}
    else:
        assert not list(tr.model.named_buffers())


# ---------------------------------------------------------------- patchout
def _vit(p):
    return dict(width=64, embed_dim=32, resolution=(100, 128), heads=4, layers=2, patch_size=32,
                stride=(16, 24), in_channels=3, patchout=p)


@pytest.mark.parametrize("p", [0.0, 0.25, 0.5])
def test_patchout_with_the_jax_index_set(p):
    """Train mode equal to the JAX tower's with its index set injected
    (atol 1e-5); eval, and p = 0, the tower without patchout."""
    x = np.random.default_rng(0).standard_normal((2, 1, 100, 128)).astype(np.float32)
    jt = JaxVisionTower(**_vit(p))
    key = jax.random.PRNGKey(7)
    params = _np(jax.jit(functools.partial(jt.init, train=True))(
        {"params": jax.random.PRNGKey(0), "patchout": key}, jnp.asarray(x)))["params"]
    pt = VisionTower(**_vit(p))
    _load_tower(pt, params)
    n = pt.grid[0] * pt.grid[1]
    keep = max(int(n * (1.0 - p)), 1)
    perms = []
    with recorded_permutations(perms):
        want = jax.jit(functools.partial(jt.apply, train=True))({"params": params}, jnp.asarray(x),
                                                                rngs={"patchout": key})
    idx = _keep_set(perms[0], p) if p > 0 else None
    seen = []

    def inject(n_, keep_, device):
        seen.append((n_, keep_))
        return torch.as_tensor(idx)

    pt.patchout_indices = inject
    got = pt(torch.tensor(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert seen == ([(n, keep)] if p > 0 else [])
    with torch.no_grad():
        ev = pt(torch.tensor(x), train=False)
    np.testing.assert_allclose(ev.numpy(), np.asarray(jax.jit(jt.apply)({"params": params}, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    assert len(seen) == (1 if p > 0 else 0)  # eval draws nothing


def test_patchout_draws_from_the_train_state_and_a_resume_replays_it(tmp_path):
    over = FLAGSHIP_TINY + ["model.audio.patchout=0.25", f"alias_root={tmp_path}",
                            f"model_root={tmp_path}", "model_name=po"]
    tr = Trainer(over, device="cpu", steps_per_epoch=SPE)
    assert tr.model.audio.patchout_generator is tr.state.generator
    images, audios = _va_inputs(tr.cfg, seed=1)
    batch = tr.make_batch(images, audios)
    tr.train_step(*batch)
    tr.global_step = tr.state.step
    tr.save()
    losses = [float(tr.train_step(*batch)["loss"]) for _ in range(2)]
    resumed = Trainer([o for o in over if o != "model_file="] + ["model_file=00000001"],
                      device="cpu", steps_per_epoch=SPE)
    again = [float(resumed.train_step(*batch)["loss"]) for _ in range(2)]
    assert again == losses
    for k, p in tr.trainable.items():
        assert torch.equal(p, resumed.trainable[k]), k
    fresh = Trainer(FLAGSHIP_TINY + ["model.audio.patchout=0.25"], device="cpu", steps_per_epoch=SPE)
    fresh.state.generator.manual_seed(123)
    assert float(fresh.train_step(*batch)["loss"]) != pytest.approx(losses[0], rel=1e-7)


# ------------------------------------------------------ the init priority
MIXED = BASE + [  # a CLIP-seeded ViT image tower beside a meme-seeded DeiT audio tower
    "+model/image=vit_val", "+model/audio=deit", "model.image.width=64",
    "model.image.embed_dim=32", "model.image.encoder.layers=2", "model.image.heads=4",
    "running.audio.max_len=64", "model.audio.width=64", "model.audio.layers=2",
    "model.audio.heads=4",
]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from torch_oracle import TorchText, TorchVisual, clip_state_dict

    root = tmp_path_factory.mktemp("weights")
    torch.manual_seed(0)
    torch.save(clip_state_dict(TorchVisual(width=64, layers=2, heads=4, embed_dim=32),
                               TorchText(width=32, layers=2, heads=4, embed_dim=32)),
               root / "clip-tiny.pt")
    torch.save(timm_deit_state_dict(), root / "deit.pth")
    return root


def _mixed(weights, run, *extra):
    return MIXED + [f"running.clip_model_root={weights}", "running.clip_model_name=clip-tiny",
                    f"model.audio.meme_path={weights}/deit.pth", f"alias_root={run}",
                    f"model_root={run}", "model_name=m", *extra]


def test_meme_seeds_the_deit_tower_and_clip_the_others(weights, tmp_path):
    tr = Trainer(_mixed(weights, tmp_path), device="cpu", steps_per_epoch=SPE)
    want = port_deit(torch.load(weights / "deit.pth"), tr.model.audio)
    for k, p in tr.model.audio.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    clip = clip_port.port_clip_visual(
        clip_port.split_clip_state_dict(torch.load(weights / "clip-tiny.pt"))[0], tr.model.image)
    for k, p in tr.model.image.named_parameters():
        assert torch.equal(p.detach(), clip[k]), k


def test_a_missing_meme_warns_and_keeps_the_init(weights, tmp_path, capsys):
    tr = Trainer(_mixed(weights, tmp_path, f"model.audio.meme_path={tmp_path}/none.pth"),
                 device="cpu", steps_per_epoch=SPE)
    assert "failed to load the meme" in capsys.readouterr().out
    plain = Trainer(_mixed(weights, tmp_path, "model.audio.meme_path="), device="cpu",
                    steps_per_epoch=SPE)
    for k, p in tr.model.audio.named_parameters():
        assert torch.equal(p, plain.model.audio.state_dict()[k]), k


def test_a_checkpoint_outranks_the_meme(weights, tmp_path):
    tr = Trainer(_mixed(weights, tmp_path), device="cpu", steps_per_epoch=SPE)
    images, audios = _va_inputs(tr.cfg)
    tr.train_step(*tr.make_batch(images, audios))
    tr.global_step = tr.state.step
    tr.save()
    resumed = Trainer(_mixed(weights, tmp_path, "model_file=00000001"), device="cpu",
                      steps_per_epoch=SPE)
    for k, p in tr.model.named_parameters():
        assert torch.equal(p, resumed.model.state_dict()[k]), k


# ----------------------------------------------------------------- serving
def test_engine_serves_resnet_towers_with_their_saved_statistics(tmp_path):
    """A VA trainer's step directory (the audio tower in ``model.npz`` and
    its statistics in ``batch_stats.npz``, the frozen image tower in
    ``state.pt``) serves both ResNet towers in eval mode on the trained
    statistics; ``export_pth`` warns and writes no ``.pth``."""
    over = RN_TINY + [f"alias_root={tmp_path}", f"model_root={tmp_path}", "model_name=rn",
                      "export_pth=True"]
    tr = Trainer(over, device="cpu", steps_per_epoch=SPE)
    images, audios = _va_inputs(tr.cfg)
    tr.train_step(*tr.make_batch(images, audios))
    tr.global_step = tr.state.step
    path = tr.save()
    assert os.path.exists(os.path.join(path, "batch_stats.npz"))
    assert not os.path.exists(os.path.join(path, "00000001.pth"))
    eng = InferenceEngine([o for o in over if o != "model_file="] + ["model_file=00000001"],
                          batch_size=4, device="cpu")
    for k, b in tr.model.named_buffers():
        assert torch.equal(b, dict(eng.model.named_buffers())[k]), k
    tr.model.eval()
    with torch.no_grad():
        want = tr.model.encode_audio(torch.tensor(audios)).numpy()
    got = eng.embed_audio(audios)
    np.testing.assert_allclose(got, want / np.linalg.norm(want, axis=-1, keepdims=True),
                               rtol=0, atol=1e-5)
    assert eng.embed_images(images).shape == (B, 32)


# ---------------------------------------------------------------- launchers
def _launch(script, tmp_path, *args, **env):
    """The arguments the launcher ``script`` (a path under the repo) passes
    to ``python``, run with a ``python`` on PATH that records them."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fake = tmp_path / "python"
    fake.write_text('#!/bin/sh\nprintf "%s\\n" "$@" > "$ARGS_OUT"\n')
    fake.chmod(0o755)
    out = tmp_path / "args.txt"
    env = dict(os.environ, PATH=f"{tmp_path}:{os.environ['PATH']}", ARGS_OUT=str(out), **env)
    subprocess.run(["sh", os.path.join(root, script), *args], env=env, check=True,
                   cwd=str(tmp_path), timeout=30)
    return out.read_text().split()


@pytest.mark.parametrize("script,run_type", [("run_bimodal_va.sh", "bimodal"),
                                             ("run_bimodal_at.sh", "trimodal")])
def test_the_launchers_are_the_jax_packages_without_the_mesh(script, run_type, tmp_path):
    """bash/torch/*.sh pass the JAX launchers' overrides to ``python -m
    vipant_tpu_torch``, the mesh's ``mesh.data=-1`` too since the port runs
    the data axis, and they compose in the port."""
    jax_args = _launch(f"bash/{script}", tmp_path, run_type, "platform=cpu")
    port_args = _launch(f"bash/torch/{script}", tmp_path, run_type, "platform=cpu")
    assert jax_args[0] == "train.py" and port_args[:2] == ["-m", "vipant_tpu_torch"]
    jax_args, port_args = jax_args[1:], port_args[2:]
    assert [a for a in jax_args if a not in port_args] == []
    assert [a for a in port_args if a not in jax_args] == []
    cfg = compose(port_args)
    assert str(cfg.platform) == "cpu" and int(cfg.mesh.data) == -1


@pytest.mark.parametrize("backbone,image,audio", [
    ("deit", (DeiTTower, (14, 14), (16, 16), 3), (DeiTTower, (99, 12), (16, 16), 1)),
    ("rn50_val", (ResNetTower, (7, 7), None, 3), (ResNetTower, (31, 4), None, 3)),
])
def test_the_va_launchers_backbone_switch_builds_the_published_towers(backbone, image, audio,
                                                                      tmp_path):
    """README's command line (``BACKBONE=deit ... bimodal
    model.audio.meme_path=...``) composes DeiT-B/16 towers (the audio tower
    at patch 16, stride 10 x 10, one channel: grid 99 x 12) and RN50 towers
    (grids 7 x 7 and 31 x 4, the log-mel broadcast to the stem's 3
    channels), none of vit_val's patching merged in; the towers are built
    on the meta device."""
    args = _launch("bash/torch/run_bimodal_va.sh", tmp_path, "bimodal",
                   "model.audio.meme_path=/models/deit.pth", BACKBONE=backbone)
    cfg = compose(args[2:])
    for build, sub, (cls, grid, patch, cin) in ((build_image_head, cfg.model.image, image),
                                                (build_audio_head, cfg.model.audio, audio)):
        tower = build(sub, device="meta")
        assert isinstance(tower, cls) and tower.grid == grid
        stem = tower.patch_embed if patch is not None else tower.pre_encoder.conv1
        assert stem.weight.shape[1] == cin
        if patch is not None:
            assert tower.patch_hw == patch
