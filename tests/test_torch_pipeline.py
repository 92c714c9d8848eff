"""The port's pipe axis (vipant_tpu_torch/parallel/pipeline.py, the stacked
trunk, the trainer on ``mesh.pipe``) against the JAX package on the CPU,
mirroring tests/test_pipeline.py's 13 tests.

The JAX side runs in this process (``make_train_step`` on the global batch,
``StackedTransformer``, its layout converters and LARS); the port's side on
gloo ranks (tests/torch_dist_worker.py), each pipe rank holding its stage's
layers of every stacked trunk under their reference names.

Tolerances (``compute_dtype=float32``): each step's loss at rtol 1e-5, grad
norm at rtol 1e-4 (1e-3 after the first step), every trainable grad of the
first step (the stages' gathered) at rtol 1e-3 with atol 1e-3 * max |ref|,
the params after each step at atol 1e-6; forwards at rtol 1e-5 with atol
1e-5 * max |ref|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipant_tpu.config import compose as jax_compose
from vipant_tpu.models import build_main_model as jax_build, init_model
from vipant_tpu.optim.lars import lars as jax_lars
from vipant_tpu.parallel import stack_block_tree, unstack_block_tree as jax_unstack
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.models import build_main_model
from vipant_tpu_torch.nn.layers import Transformer
from vipant_tpu_torch.optim.lars import LARS
from vipant_tpu_torch.parallel import Mesh, pipeline, shard_model
from vipant_tpu_torch.parallel.tensor import Elsewhere

from test_torch_parallel import CLAP, CVAP, JAX_MESH, SPE, _inputs, jax_steps
from test_torch_tensor_parallel import GRAD_TOL, _check_steps, _close
from torch_dist_worker import run_ranks

PIPE = ["mesh.pipe=2", "mesh.data=-1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RUNS = {  # label -> (overrides, extra port overrides, steps, JAX extra overrides)
    "cvap": (CVAP, [], 3, []),
    "pack": (CVAP, ["model.image.token_pack=4"], 1, ["model.image.token_pack=4"]),
    "gc": (CVAP, ["running.grad_cache.alive=True", "running.grad_cache.chunk_size=4"], 1, []),
    "clap": (CLAP, ["mesh.microbatches=4"], 2, []),
}


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    """One group of 2 gloo ranks on mesh.pipe=2 running every case of
    :data:`RUNS` against its JAX global step; CVAP with a save after its
    first step and a resume."""
    root = tmp_path_factory.mktemp("pipe")
    want, runs, jax_cache = {}, {}, {}
    for label, (over, extra, steps, jextra) in RUNS.items():
        case = "clap" if over is CLAP else "cvap"
        kw = {"retrieval": True} if case == "clap" else None
        args = _inputs(case, jax_compose(over + JAX_MESH))
        key = (case, tuple(jextra), steps)
        if key not in jax_cache:
            jax_cache[key] = jax_steps(over + jextra, args, kw, steps=steps)
        params, _, w, grads = jax_cache[key]
        want[label] = (w, grads)
        spec = {"overrides": over + extra + PIPE + [f"alias_root={root}/{label}"], "args": args,
                "params": params, "spe": SPE, "steps": steps}
        if label == "cvap":
            spec.update(save=True, root=str(root))
        runs[label] = ("mesh_steps", spec)
    got = run_ranks(root, "multi", {"runs": runs}, timeout=300)
    return want, got


@pytest.mark.parametrize("label", ["cvap", "clap"])
def test_a_pipelined_step_matches_the_jax_global_step(piped, label):
    """tests/test_pipeline.py:180: stacked towers on mesh.pipe=2 train as the
    plain step; the text tower's causal mask reaches both stages (CLAP, 4
    microbatches by ``mesh.microbatches``)."""
    want, got = piped
    w, grads = want[label]
    runs = [g[label] for g in got]
    assert [r["coords"]["pipe"] for r in runs] == [0, 1]
    _check_steps(runs, w, grads, steps=len(w))


def test_each_stage_holds_its_layers_under_their_reference_names(piped):
    """tests/test_pipeline.py:160: whole layers live on their stage; the
    position embeddings, norms and projections on every rank."""
    _, got = piped
    for stage, g in enumerate(got):
        local, splits = g["cvap"]["local"], g["cvap"]["splits"]
        blocks = {int(k.split(".")[3]) for k in local if ".encoder.resblocks." in k}
        assert blocks == {stage}, blocks
        assert "audio.misc.positional_embedding" in local and "audio.post_encoder.proj" in local
        assert splits["audio.encoder.resblocks.1.attn.in_proj_weight"] == ("pipe", "stage")
        assert "audio.misc.positional_embedding" not in splits


def test_the_grad_cache_composes_with_the_pipeline(piped):
    """tests/test_pipeline.py:252: the two-pass gradient cache over
    pipelined towers equals the plain step."""
    want, got = piped
    _check_steps([g["gc"] for g in got], *want["gc"], steps=1)


def test_token_packing_composes_with_the_pipeline(piped):
    """tests/test_pipeline.py:374: the image tower's pack mask reaches every
    stage (JAX's ``consts``)."""
    want, got = piped
    _check_steps([g["pack"] for g in got], *want["pack"], steps=1)


def test_a_pipelined_save_resumes_bitwise_and_loads_on_one_rank(piped, tmp_path):
    """tests/test_pipeline.py:397 and :434: the file holds every layer under
    its reference name; the same mesh resumes bitwise, and one rank resumes
    it within the step tolerance."""
    _, got = piped
    for g in got:
        r = g["cvap"]
        for k, v in r["steps"][-1]["params"].items():
            assert np.array_equal(v, r["resumed"][k]), k
    saved = got[0]["cvap"]["saved"]
    sd = torch.load(os.path.join(saved, "state.pt"), map_location="cpu", weights_only=True)
    assert {k for k in sd["params"] if ".resblocks." in k} >= {
        "audio.encoder.resblocks.0.ln_1.weight", "audio.encoder.resblocks.1.ln_1.weight"}
    over = [o for o in RUNS["cvap"][0]]
    one = run_ranks(tmp_path, "mesh_steps", {
        "overrides": over + ["mesh.data=-1", f"alias_root={tmp_path}/one",
                             f"model_root={os.path.dirname(os.path.dirname(saved))}",
                             f"model_file={os.path.basename(saved)}"],
        "args": _inputs("cvap", jax_compose(over + JAX_MESH)), "steps": 1, "spe": SPE}, world=1)[0]
    for k, v in got[0]["cvap"]["steps"][1]["params"].items():
        np.testing.assert_allclose(one["steps"][0]["params"][k], v, rtol=0, atol=1e-6, err_msg=k)


def test_four_stages_with_a_microbatch_override(tmp_path):
    """tests/test_pipeline.py:345: 4 stages of one layer each, 4 microbatches
    by ``mesh.microbatches``."""
    over = CVAP + ["model.image.encoder.layers=4"]
    args = _inputs("cvap", jax_compose(over + JAX_MESH))
    params, _, want, grads = jax_steps(over, args, steps=1)
    got = run_ranks(tmp_path, "mesh_steps", {
        "overrides": over + ["mesh.pipe=4", "mesh.data=-1", "mesh.microbatches=4"], "args": args,
        "params": params, "spe": SPE, "steps": 1}, world=4, timeout=300)
    assert [g["coords"]["pipe"] for g in got] == [0, 1, 2, 3]
    _check_steps(got, want, grads, steps=1)


# ------------------------------------------------------------- in process
def test_the_microbatch_rule():
    """``_default_microbatches``: 2S, else S, else the largest divisor <= 2S."""
    from vipant_tpu.parallel.pipeline import _default_microbatches

    for b in range(1, 33):
        for s in (2, 3, 4):
            assert pipeline.default_microbatches(b, s) == _default_microbatches(b, s), (b, s)


def test_the_layout_converter_inverts_the_jax_stack():
    """tests/test_pipeline.py:78: the port's ``unstack_block_tree`` undoes
    the JAX ``stack_block_tree``, and ``unstack_in_tree`` finds a stacked
    trunk anywhere in a tree."""
    rng = np.random.default_rng(0)
    tree = {f"block_{i}": {"attn": {"qkv": {"kernel": rng.standard_normal((4, 12)).astype(np.float32)}},
                           "ln_1": {"scale": rng.standard_normal(4).astype(np.float32)}}
            for i in range(3)}
    stacked = jax.tree_util.tree_map(np.asarray, stack_block_tree(tree))
    assert pipeline.is_stacked_blocks(stacked)
    back = pipeline.unstack_block_tree(stacked)
    ref = jax.tree_util.tree_map(np.asarray, jax_unstack(stacked))
    for i in range(3):
        for path in (("attn", "qkv", "kernel"), ("ln_1", "scale")):
            a, b, c = back[f"block_{i}"], ref[f"block_{i}"], tree[f"block_{i}"]
            for p in path:
                a, b, c = a[p], b[p], c[p]
            assert np.array_equal(a, c) and np.array_equal(b, c)
    flat = pipeline.unstack_in_tree({"encoder": {"transformer": {"blocks": stacked}}})
    assert set(flat["encoder"]["transformer"]) == {"block_0", "block_1", "block_2"}


def _jax_stacked_audio(extra=()):
    cfg = jax_compose(CVAP + ["model.audio.stacked=true", *extra])
    model = jax_build(cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda: init_model(cfg, model))()["params"])
    return cfg, model, params


def test_a_stacked_tower_without_a_pipe_axis_runs_sequentially():
    """tests/test_pipeline.py:107 and :235: ``model.audio.stacked=true`` builds,
    loads a stacked JAX tree (unstacked by ``ckpt/from_jax.py``) and, with no
    pipe axis, runs its layers in order: the JAX stacked tower's embedding."""
    cfg, model, params = _jax_stacked_audio()
    assert "blocks" in params["audio"]["encoder"]["transformer"]
    x = np.random.default_rng(1).standard_normal((2, 1, 100, 128)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x), method=model.encode_audio))
    port = build_main_model(compose(CVAP + ["model.audio.stacked=true"]), device="cpu")
    from_jax.load_params(port, params)
    assert port.audio.encoder.stacked and port.audio.encoder.pipe is None
    with torch.no_grad():
        got = port.encode_audio(torch.from_numpy(x)).numpy()
    _close(got, want, 1e-5, "stacked audio tower")


def test_lars_over_the_stacked_layout_equals_the_ports_per_layer_lars():
    """tests/test_pipeline.py:126: the JAX LARS on a stacked [L, ...] leaf
    takes a trust ratio per layer, which the port's unrolled LARS does."""
    rng = np.random.default_rng(0)
    L = 3
    blocks = {f"block_{i}": {"kernel": rng.standard_normal((8, 8)).astype(np.float32),
                             "bias": rng.standard_normal(8).astype(np.float32)} for i in range(L)}
    grads = jax.tree_util.tree_map(lambda p: 0.1 * p + 0.01, blocks)
    params_s = {"trunk": {"blocks": stack_block_tree(blocks)}}
    tx = jax_lars(lambda step: 0.1)
    up, _ = tx.update({"trunk": {"blocks": stack_block_tree(grads)}}, tx.init(params_s), params_s)
    up = jax_unstack(up["trunk"]["blocks"])
    named = {f"{i}.{k}": torch.nn.Parameter(torch.tensor(blocks[f"block_{i}"][k]))
             for i in range(L) for k in ("kernel", "bias")}
    opt = LARS(named.items())
    for group in opt.param_groups:
        group["lr"] = 0.1
    before = {n: p.detach().clone() for n, p in named.items()}
    for n, p in named.items():
        i, k = n.split(".")
        p.grad = torch.tensor(grads[f"block_{i}"][k])
    opt.step()
    for n, p in named.items():  # the updated params, as tests/test_torch_optim.py holds them
        i, k = n.split(".")
        np.testing.assert_allclose(p.detach().numpy(), before[n].numpy() + np.asarray(up[f"block_{i}"][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_the_pipe_placement_and_the_deit_blocks_name():
    """tests/test_pipeline.py:160 and :294: on one rank's view of a pipe=2
    mesh (no collective runs) a stacked trunk keeps its stage's layers and
    holds nothing of the others; the DeiT tower's unrolled trunk, which also
    sits under a ``blocks`` name, is never pipelined, and ``unstack_in_tree``
    leaves its ``block_{i}`` tree as it is."""
    model = build_main_model(compose(CVAP + ["model.audio.stacked=true"]), device="cpu")
    pl = shard_model(model, Mesh(1, 1, None, "cpu", pipe=2))
    enc = model.audio.encoder
    assert isinstance(enc.resblocks[0], Elsewhere) and not isinstance(enc.resblocks[1], Elsewhere)
    assert enc.pipe is not None and model.image.encoder.pipe is None  # the image tower is not stacked
    assert pl.splits["audio.encoder.resblocks.0.mlp.c_fc.weight"].stage == 0
    assert not pl.here("audio.encoder.resblocks.0.mlp.c_fc.weight")
    assert pl.here("audio.encoder.resblocks.1.mlp.c_fc.weight") and pl.here("audio.misc.class_embedding")
    deit = build_main_model(compose(["+running=bimodal", "+model/image=vit_val", "+model/audio=deit",
                                     "+model/text=dummy", "+model/loss=ce", "+optimizer=standard",
                                     "+running/audio=default", "worker=CVAP", "model.audio.stacked=true",
                                     "model.audio.encoder.layers=2", "model.audio.width=64",
                                     "model.audio.heads=4", "model.image.width=64",
                                     "model.image.encoder.layers=2", "model.image.heads=4"]),
                            device="cpu")
    pl = shard_model(deit, Mesh(1, 1, None, "cpu", pipe=2))
    assert not any(k.startswith("audio.") for k in pl.splits)
    tree = {"audio": {"blocks": {f"block_{i}": {"attn": {"qkv": {"kernel": np.zeros((4, 3, 4))}}}
                                 for i in range(2)}}}
    assert set(pipeline.unstack_in_tree(tree)["audio"]["blocks"]) == {"block_0", "block_1"}


def test_a_remat_stacked_trunk_has_the_ports_grads():
    """tests/test_pipeline.py:498: the JAX stacked trunk with remat has the
    grads of the plain one; the port (which keeps no remat) matches it."""
    from vipant_tpu.nn.layers import StackedTransformer

    B, T, C, H, L = 2, 7, 32, 4, 3
    x = np.random.default_rng(0).standard_normal((B, T, C)).astype(np.float32)
    s = StackedTransformer(layers=L, num_heads=H, remat=True)
    ps = jax.tree_util.tree_map(np.asarray, s.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    gx, gp = jax.grad(lambda xx, p: jnp.sum(s.apply({"params": p}, xx) ** 2), argnums=(0, 1))(
        jnp.asarray(x), ps)
    port = Transformer(C, L, H)
    sd = {k[len("encoder."):]: torch.tensor(v) for k, v in
          from_jax.tower_state_dict({"encoder": {"transformer": ps}}).items()}
    port.load_state_dict(sd)
    port.stacked = True
    xt = torch.tensor(x, requires_grad=True)
    (port(xt) ** 2).sum().backward()
    _close(xt.grad.numpy(), np.asarray(gx), GRAD_TOL, "dx")
    want = from_jax.tower_state_dict({"encoder": {"transformer": jax.tree_util.tree_map(np.asarray, gp)}})
    for k, p in port.named_parameters():
        _close(p.grad.numpy(), want["encoder." + k], GRAD_TOL, k)
