"""The port's model axis (vipant_tpu_torch/parallel/tensor.py, the sub-blocks'
``tp`` paths, the trainer on ``mesh.model``) against the JAX package on
the CPU.

The JAX side runs in this process, on the 8 virtual CPU devices
(tests/conftest.py): the fused sub-blocks on a data x model mesh as
tests/test_fused_attn.py:308, :341, :404 and :441 run them (Pallas in
interpret mode), and ``make_train_step`` on the global batch. The port's
side runs on gloo ranks (tests/torch_dist_worker.py), each on its model
rank's slices of the same weights.

- The sub-blocks on 2 model ranks, fp32: the attention (bare, pre-LN, with
  token packing's block-diagonal mask) and the pre-LN MLP; outputs at rtol
  1e-5 with atol 1e-5 * max |ref|, the grads of every input (the weight
  slices gathered) at rtol 1e-3 with atol 1e-3 * max |ref|. Int8: each
  rank quantizes its own slices, per-token cosine > 0.999 to JAX's int8
  tensor-parallel result (JAX's own tolerance against its unsharded int8).
- Training steps, ``compute_dtype=float32``: CVAP, CLAP retrieval (the text
  tower's vocabulary rows and projection split) and captioning (the
  decoder's token embedding and ``text_proj`` split) on ``mesh.model=2``,
  CVAP on a 4-rank data 2 x model 2 world: each step's loss at rtol 1e-5,
  grad norm at rtol 1e-4 (1e-3 at the second step), every trainable grad of
  the first step (gathered) at rtol 1e-3 with atol 1e-3 * max |ref|, the
  params after each step at atol 1e-6; the ranks' gathered params bitwise
  equal.
- Save and resume under ``mesh.model=2``: bitwise the uninterrupted run;
  the file holds the full reference-named tensors, and a one-rank trainer
  resumes it.
- The placement rule (head blocks, Megatron's split, vocabulary rows, the
  final projections; the decoder's blocks whole) without a process group.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipant_tpu.ops import fused_attn as jax_fa
from vipant_tpu.ops import fused_mlp as jax_fm
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.models import build_main_model, init_weights
from vipant_tpu_torch.parallel import Mesh, shard_model

from test_torch_parallel import CAPTION, CLAP, CVAP, JAX_MESH, SPE, _inputs, jax_steps
from torch_dist_worker import run_ranks

Bt, T, C, H = 4, 40, 64, 4
OUT_TOL, GRAD_TOL = 1e-5, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()) + 1e-12,
                               err_msg=what)


# ------------------------------------------------------------ the sub-blocks
def _tp_mesh():
    from jax.sharding import Mesh as JMesh

    return JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))


def _weights(seed):
    r = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (r.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return dict(x=f(Bt, T, C, std=0.5), lns=1 + f(C, std=0.1), lnb=f(C, std=0.05),
                wqkv=f(C, 3 * C, std=C ** -0.5).reshape(C, 3, C), bqkv=f(3, C, std=0.02),
                wout=f(C, C, std=C ** -0.5), bout=f(C, std=0.02),
                wfc=f(C, 4 * C, std=(2 * C) ** -0.5), bfc=f(4 * C, std=0.02),
                wproj=f(4 * C, C, std=(4 * C) ** -0.5), bproj=f(C, std=0.02),
                cot=f(Bt, T, C))


def _pack_bias():
    half = T // 2
    bias = np.zeros((T, T), np.float32)
    bias[:half, half:] = -1e30
    bias[half:, :half] = -1e30
    return bias


BLOCKS = {  # name -> (kind, seed, bias)
    "attn": ("attn", 2, False), "ln_attn": ("ln_attn", 3, False), "attn_pack": ("attn", 11, True),
    "mlp": ("mlp", 4, False), "ln_attn_int8": ("ln_attn_int8", 5, False),
    "mlp_int8": ("mlp_int8", 6, False),
}


def _jax_block(kind, p, bias):
    """JAX's op on the data x model mesh: its output and the grads of
    sum(out * cot) in the JAX layouts."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jb = None if bias is None else jnp.asarray(bias)
    cot = jnp.asarray(p["cot"])
    keys = {"attn": ("x", "wqkv", "bqkv", "wout", "bout"),
            "ln_attn": ("x", "wqkv", "bqkv", "wout", "bout", "lns", "lnb"),
            "mlp": ("x", "lns", "lnb", "wfc", "bfc", "wproj", "bproj")}
    keys["ln_attn_int8"], keys["mlp_int8"] = keys["ln_attn"], keys["mlp"]
    args = [jnp.asarray(p[k]) for k in keys[kind]]

    def op(*a):
        if kind == "attn":
            return jax_fa.fused_attention_block(*a, bias=jb, heads=H)
        if kind in ("ln_attn", "ln_attn_int8"):
            f = jax_fa.fused_ln_attention_block_int8 if kind.endswith("int8") else \
                jax_fa.fused_ln_attention_block
            return f(a[0], a[5], a[6], *a[1:5], bias=jb, heads=H)
        f = jax_fm.fused_ln_mlp_block_int8 if kind.endswith("int8") else jax_fm.fused_ln_mlp_block
        return f(*a, act="quick_gelu")

    mesh = _tp_mesh()
    with jax.sharding.set_mesh(mesh):
        xs = jax.device_put(args[0], NamedSharding(mesh, P("data")))
        out = np.asarray(jax.jit(op)(xs, *args[1:]))
        if kind.endswith("int8"):
            return out, None
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(op(*a) * cot),
                                 argnums=tuple(range(len(args)))))(xs, *args[1:])
    return out, {k: np.asarray(g) for k, g in zip(keys[kind], grads)}


def _torch_weights(p):
    """The JAX layouts -> the port's (torch) ones."""
    return dict(wqkv=p["wqkv"].reshape(C, 3 * C).T.copy(), bqkv=p["bqkv"].reshape(-1).copy(),
                wout=p["wout"].T.copy(), bout=p["bout"], lns=p["lns"], lnb=p["lnb"],
                wfc=p["wfc"].T.copy(), bfc=p["bfc"], wproj=p["wproj"].T.copy(), bproj=p["bproj"])


def _to_jax_grad(k, g):
    if k == "wqkv":
        return g.T.reshape(C, 3, C)
    if k == "bqkv":
        return g.reshape(3, C)
    if k in ("wout", "wfc", "wproj"):
        return g.T
    return g


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    cases, want = {}, {}
    for name, (kind, seed, packed) in BLOCKS.items():
        p = _weights(seed)
        bias = _pack_bias() if packed else None
        want[name] = _jax_block(kind, p, bias)
        w = _torch_weights(p)
        if kind.startswith("attn"):
            w = {k: w[k] for k in ("wqkv", "bqkv", "wout", "bout")}
        elif kind.startswith("ln_attn"):
            w = {k: w[k] for k in ("wqkv", "bqkv", "wout", "bout", "lns", "lnb")}
        else:
            w = {k: w[k] for k in ("lns", "lnb", "wfc", "bfc", "wproj", "bproj")}
        cases[name] = {"kind": kind, "x": p["x"], "w": w, "cot": p["cot"], "heads": H,
                       "bias": bias, "act": "quick_gelu"}
    got = run_ranks(tmp_path_factory.mktemp("tp_blocks"), "tp_blocks", {"cases": cases})
    return want, got


@pytest.mark.parametrize("name", [n for n in BLOCKS if not n.endswith("int8")])
def test_a_sub_block_on_two_model_ranks_matches_jax_tensor_parallel(blocks, name):
    """The JAX op under a data x model mesh head-parallelizes (its shards'
    partial out-projections psum'd, the residual after the sum); the port's
    two ranks each run the chain on their head block or hidden columns and
    sum over the model group. Output and every grad (the slices gathered)."""
    want, got = blocks
    out, grads = want[name]
    for r in got:
        _close(r[name]["out"], out, OUT_TOL, f"{name} out")
        for k, g in grads.items():
            _close(_to_jax_grad(k, r[name]["grads"][k]), g, GRAD_TOL, f"{name} d{k}")
    assert np.array_equal(got[0][name]["out"], got[1][name]["out"])


@pytest.mark.parametrize("name", ["ln_attn_int8", "mlp_int8"])
def test_int8_sub_blocks_quantize_each_ranks_slices_as_jax_does(blocks, name):
    """Each rank quantizes its own weight slices after the split; the
    context's per-token scale covers the rank's own heads (the MLP's
    activation scale its own hidden columns). Held to JAX's int8
    tensor-parallel result at JAX's own tolerance: per-token cosine > 0.999."""
    want, got = blocks
    w = want[name][0].astype(np.float64)
    for r in got:
        g = r[name]["out"].astype(np.float64)
        cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(w, axis=-1) + 1e-9)
        assert cos.min() > 0.999, (name, cos.min())


# -------------------------------------------------------------- the steps
def _check_steps(got, want, grads, steps=2):
    for g in got:
        for i in range(steps):
            s, w = g["steps"][i], want[i]
            assert s["loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert s["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4 if i == 0 else 1e-3)
            assert sorted(s["params"]) == sorted(w["params"])
            for k, v in w["params"].items():
                np.testing.assert_allclose(s["params"][k], v, rtol=0, atol=1e-6, err_msg=k)
        assert sorted(g["grads"]) == sorted(grads)
        for k, v in grads.items():
            _close(g["grads"][k], v, GRAD_TOL, f"grad {k}")
    for k in got[0]["steps"][-1]["params"]:
        for g in got[1:]:
            assert np.array_equal(g["steps"][-1]["params"][k], got[0]["steps"][-1]["params"][k]), k


STEP_CASES = {"cvap": (CVAP, None), "clap": (CLAP, {"retrieval": True}),
              "caption": (CAPTION, {"retrieval": False})}


@pytest.fixture(scope="module")
def model_steps(tmp_path_factory):
    """The JAX global steps, then one group of 2 gloo ranks on mesh.model=2
    running each case, CVAP with a save after its first step and a resume."""
    root = tmp_path_factory.mktemp("tp_steps")
    want, runs = {}, {}
    for case, (over, kw) in STEP_CASES.items():
        args = _inputs(case, compose(over + JAX_MESH))
        params, _, w, grads = jax_steps(over, args, kw, steps=2 if case != "cvap" else 3)
        want[case] = (w, grads)
        extra = ["mesh.model=2", "mesh.data=-1", f"alias_root={root}/{case}"]
        spec = {"overrides": over + extra, "args": args, "params": params, "spe": SPE,
                "steps": 3 if case == "cvap" else 2}
        if case == "cvap":
            spec.update(save=True, root=str(root))
        runs[case] = ("mesh_steps", spec)
    got = run_ranks(root, "multi", {"runs": runs}, timeout=300)
    return want, got, runs


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_a_model_axis_of_two_trains_as_the_jax_global_step(model_steps, case):
    want, got, _ = model_steps
    w, grads = want[case]
    runs = [g[case] for g in got]
    assert [r["shape"] for r in runs] == [{"data": 1, "model": 2, "pipe": 1, "seq": 1}] * 2
    assert [r["coords"]["model"] for r in runs] == [0, 1]
    _check_steps(runs, w, grads, steps=len(w))


def test_the_weights_are_split_and_the_replicas_hold_their_slices(model_steps):
    _, got, _ = model_steps
    r = got[0]["clap"]
    splits, local = r["splits"], r["local"]
    qkv = "audio.encoder.resblocks.0.attn.in_proj_weight"
    assert splits[qkv] == ("model", "qkv") and local[qkv][0] * 2 == 3 * local[qkv][1]
    assert splits["audio.encoder.resblocks.0.mlp.c_fc.weight"] == ("model", "rows")
    assert splits["audio.encoder.resblocks.0.mlp.c_proj.weight"] == ("model", "cols")
    assert splits["audio.encoder.resblocks.0.attn.out_proj.weight"] == ("model", "cols")
    assert splits["text.pre_encoder.token_embedding.weight"] == ("model", "rows")
    assert splits["text.post_encoder.proj"] == ("model", "rows")
    assert splits["audio.post_encoder.proj"] == ("model", "rows")
    for whole in ("audio.encoder.resblocks.0.attn.out_proj.bias", "audio.encoder.resblocks.0.ln_1.weight",
                  "audio.misc.positional_embedding", "audio.encoder.resblocks.0.mlp.c_proj.bias"):
        assert whole not in splits
    cap = got[0]["caption"]["splits"]
    assert cap["decoder.token_embedding"] == ("model", "rows")
    assert cap["decoder.text_proj"] == ("model", "rows")
    assert not any(k.startswith("decoder.transformer.") for k in cap)  # the decoder's blocks whole


def test_a_model_axis_save_resumes_bitwise_and_holds_the_full_tensors(model_steps):
    _, got, runs = model_steps
    for g in got:
        r = g["cvap"]
        for k, v in r["steps"][-1]["params"].items():
            assert np.array_equal(v, r["resumed"][k]), k
    saved = got[0]["cvap"]["saved"]
    sd = torch.load(os.path.join(saved, "state.pt"), map_location="cpu", weights_only=True)
    for k, v in got[0]["cvap"]["steps"][0]["params"].items():
        assert tuple(sd["params"][k].shape) == v.shape and np.array_equal(sd["params"][k].numpy(), v), k
    mom = sd["opt_state"]["inner"]["state"]
    assert {tuple(t.shape) for st in mom.values() for t in st.values() if t.dim()} >= {(3 * 64, 64)}


def test_a_one_rank_trainer_resumes_a_model_axis_save_and_back(model_steps, tmp_path):
    """The file is the same whatever the mesh: a one-rank trainer resumes
    the model=2 save and takes the run's next steps within the step
    tolerance, and its own save loads into a model=2 trainer."""
    _, got, runs = model_steps
    saved = got[0]["cvap"]["saved"]
    over = runs["cvap"][1]["overrides"]
    base = [o for o in over if not o.startswith(("mesh.", "alias_root"))]
    resume = [f"model_root={os.path.dirname(os.path.dirname(saved))}",
              f"model_file={os.path.basename(saved)}"]
    spec = {"overrides": base + ["mesh.data=-1", f"alias_root={tmp_path}/one"] + resume,
            "args": runs["cvap"][1]["args"], "steps": 2, "spe": SPE, "save": True,
            "root": str(tmp_path)}
    one = run_ranks(tmp_path, "mesh_steps", spec, world=1)[0]
    want = got[0]["cvap"]["steps"]
    for i in range(2):
        assert one["steps"][i]["loss"] == pytest.approx(want[i + 1]["loss"], rel=1e-5)
        for k, v in want[i + 1]["params"].items():
            np.testing.assert_allclose(one["steps"][i]["params"][k], v, rtol=0, atol=1e-6, err_msg=k)
    back = {"overrides": base + ["mesh.model=2", "mesh.data=-1", f"alias_root={tmp_path}/two",
                                 f"model_root={os.path.dirname(os.path.dirname(one['saved']))}",
                                 f"model_file={os.path.basename(one['saved'])}"],
            "args": runs["cvap"][1]["args"], "steps": 1, "spe": SPE}
    two = run_ranks(tmp_path, "mesh_steps", back)
    for r in two:
        for k, v in one["steps"][1]["params"].items():
            np.testing.assert_allclose(r["steps"][0]["params"][k], v, rtol=0, atol=1e-6, err_msg=k)


def test_data_two_by_model_two_on_four_ranks(model_steps, tmp_path):
    """A 4-rank world laid out data-major: ranks (0, 1) and (2, 3) are the
    model groups of data shards 0 and 1; each shard reads its half of the
    batch, the grads average over the data group, ZeRO-1 deals each model
    rank's own leaves over it. The JAX steps are the module fixture's."""
    want, _, runs = model_steps
    w, grads = want["cvap"]
    spec = runs["cvap"][1]
    over = [o for o in spec["overrides"] if not o.startswith(("mesh.", "alias_root"))]
    got = run_ranks(tmp_path, "mesh_steps",
                    {"overrides": over + ["mesh.model=2", "mesh.data=2", "mesh.zero=true"],
                     "args": spec["args"], "params": spec["params"], "spe": SPE}, world=4, timeout=300)
    assert [(g["coords"]["data"], g["coords"]["model"]) for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    _check_steps(got, w, grads)


def test_the_placement_rule_without_a_group():
    """shard_model on one rank's view of a model=2 mesh (no collective runs):
    the slices, their reference names, and the whole leaves."""
    cfg = compose(CLAP)
    model = build_main_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    full = {k: p.detach().clone() for k, p in model.named_parameters()}
    pl = shard_model(model, Mesh(1, 1, None, "cpu", model=2))
    own = dict(model.named_parameters())
    assert sorted(own) == sorted(full)
    for k, p in own.items():
        s = pl.splits.get(k)
        want = full[k] if s is None else pl.local(k, full[k])
        assert torch.equal(p.detach(), want), k
    q = "audio.encoder.resblocks.1.attn.in_proj_weight"
    C_ = full[q].shape[1]
    assert torch.equal(own[q][:C_ // 2], full[q][C_ // 2:C_])  # rank 1: the second head block of q
    assert torch.equal(own[q][C_ // 2:C_], full[q][C_ + C_ // 2:2 * C_])  # ... and of k
    assert model.audio.encoder.resblocks[0].attn.tp.model == 2
