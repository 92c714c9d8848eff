"""The port's seq axis (vipant_tpu_torch/parallel/sequence.py: ring
attention, the stacked trunk split over the ring, the trainer on
``mesh.seq``) against the JAX package on the CPU, mirroring
tests/test_sequence_parallel.py's 10 tests.

The JAX side runs in this process: ``ring_attention`` in a ``shard_map``
over a seq axis of the 8 virtual devices, ``StackedTransformer``, and
``make_train_step`` on the global batch. The port's side runs on gloo ranks
(tests/torch_dist_worker.py), each on its tokens: the ring ops on 4 ranks
(the next and the previous rank differ), the trunks and steps on 2.

fp32: the ring's output at rtol 1e-5 with atol 1e-5 * max |ref| and its
grads at rtol 1e-3 with atol 1e-3 * max |ref| against JAX's ring; a trunk's
output likewise and its params' grads at the grad tolerance; steps as
tests/test_torch_tensor_parallel.py holds them. bf16: cosine >= 0.999 per
tensor.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from vipant_tpu.config import compose as jax_compose
from vipant_tpu.nn.layers import StackedTransformer, causal_mask as jax_causal
from vipant_tpu.parallel import make_mesh as jax_make_mesh, ring_attention as jax_ring
from vipant_tpu.parallel.spmd import smap
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.nn.layers import Transformer
from vipant_tpu_torch.parallel import Mesh, make_mesh, sequence

from test_torch_parallel import CLAP, CVAP, JAX_MESH, SPE, _inputs, jax_steps
from test_torch_tensor_parallel import GRAD_TOL, OUT_TOL, _check_steps, _close
from torch_dist_worker import run_ranks

SEQ = ["mesh.seq=2", "mesh.data=-1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ------------------------------------------------------------ the ring op
def _qkvw(seed, B, T, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4)]


def _dead_bias(T):
    bias = np.zeros((T, T), np.float32)
    bias[[0, 5, 13], :] = -np.inf  # rows on three different ring shards
    return bias


RING_CASES = {  # name -> (seed, B, T, H, D, bias, dtype)
    "full": (0, 4, 16, 2, 8, None, "float32"),
    "causal": (4, 4, 32, 2, 8, "causal", "float32"),
    "bf16": (3, 2, 64, 4, 16, None, "bfloat16"),
    "dead_rows": (11, 2, 16, 2, 8, "dead", "float32"),
}


def _jax_ring_ref(q, k, v, w, bias, dtype):
    """JAX's ``ring_attention`` over a seq=4 ring: output and, fp32, the grads
    of sum(out * w)."""
    mesh = jax_make_mesh(data=2, model=1, pipe=1, seq=4)
    args = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    if bias is None:
        ring = smap(lambda a, b, c: jax_ring(a, b, c, "seq"), mesh,
                    in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"))
    else:
        jb = jnp.asarray(bias)
        ring = smap(lambda a, b, c, m: jax_ring(a, b, c, "seq", bias=m), mesh,
                    in_specs=(P(None, "seq"),) * 3 + (P("seq", None),), out_specs=P(None, "seq"))
        ring = (lambda f: lambda a, b, c: f(a, b, c, jb))(ring)
    y = np.asarray(jax.jit(ring)(*args), np.float32)
    if dtype != "float32":
        return y, None
    g = jax.jit(jax.grad(lambda a, b, c: jnp.sum(ring(a, b, c) * jnp.asarray(w)),
                         argnums=(0, 1, 2)))(*args)
    return y, [np.asarray(t) for t in g]


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    cases, want = {}, {}
    for name, (seed, B, T, H, D, kind, dtype) in RING_CASES.items():
        q, k, v, w = _qkvw(seed, B, T, H, D)
        bias = None if kind is None else (np.asarray(jax_causal(T)) if kind == "causal" else _dead_bias(T))
        want[name] = _jax_ring_ref(q, k, v, w, bias, dtype)
        cases[name] = dict(q=q, k=k, v=v, w=w, bias=bias, dtype=dtype, grads=dtype == "float32")
    got = run_ranks(tmp_path_factory.mktemp("rings"), "ring_ops", {"cases": cases}, world=4)
    return want, got, cases


@pytest.mark.parametrize("name", ["full", "causal"])
def test_the_ring_matches_jax_ring_attention(rings, name):
    """tests/test_sequence_parallel.py:48 and :127: over a ring of 4 ranks, the
    output and the grads of q, k and v, the causal mask split by query rows
    (the (i - step) mod S source block)."""
    want, got, _ = rings
    y, g = want[name]
    for r in got:
        _close(r[name]["out"], y, OUT_TOL, f"{name} out")
        for n, a, b in zip("qkv", r[name]["grads"], g):
            _close(a, b, GRAD_TOL, f"{name} d{n}")


def test_the_ring_in_bf16(rings):
    """tests/test_sequence_parallel.py:366: bf16 inputs, fp32 statistics, a
    bf16 output."""
    want, got, _ = rings
    for r in got:
        assert r["bf16"]["dtype"] == "torch.bfloat16"
        assert _cos(r["bf16"]["out"], want["bf16"][0]) >= 0.999


def test_fully_masked_rows_stay_finite(rings):
    """tests/test_sequence_parallel.py:405: rows masked over every key return
    0, the others JAX's ring; the grads stay finite."""
    want, got, cases = rings
    dead = [0, 5, 13]
    for r in got:
        y = r["dead_rows"]["out"]
        assert np.isfinite(y).all() and all(np.isfinite(g).all() for g in r["dead_rows"]["grads"])
        assert np.array_equal(y[:, dead], np.zeros_like(y[:, dead]))
        alive = [t for t in range(16) if t not in dead]
        _close(y[:, alive], want["dead_rows"][0][:, alive], OUT_TOL, "alive rows")


def test_a_rank_3_bias_and_a_wrong_row_shard_are_rejected():
    mesh = Mesh(1, 0, None, "cpu", seq=2)
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="rank 3 is ambiguous"):
        sequence.ring_attention(q, q, q, mesh, torch.zeros(2, 4, 8))
    with pytest.raises(ValueError, match="row shard"):
        sequence.ring_attention(q, q, q, mesh, torch.zeros(8, 8))


# ---------------------------------------------------------- the trunk, steps
TRUNK = dict(layers=2, heads=4, width=32)


@pytest.fixture(scope="module")
def seq_runs(tmp_path_factory):
    """One group of 2 gloo ranks on a seq ring: the stacked trunk with and
    without a causal mask, then CVAP, its gradient cache, and CLAP (whose
    77-token text trunk does not split and runs whole) against the JAX
    global steps."""
    root = tmp_path_factory.mktemp("seq")
    model = StackedTransformer(layers=TRUNK["layers"], num_heads=TRUNK["heads"])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, TRUNK["width"])).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    trunk_want = {}
    for name, mask in (("plain", None), ("causal", np.asarray(jax_causal(16)))):
        m = None if mask is None else jnp.asarray(mask)
        y = np.asarray(model.apply({"params": params}, jnp.asarray(x), mask=m))
        g = jax.grad(lambda p: jnp.sum(model.apply({"params": p}, jnp.asarray(x), mask=m) ** 2))(params)
        trunk_want[name] = (y, from_jax.tower_state_dict(
            {"encoder": {"transformer": jax.tree_util.tree_map(np.asarray, g)}}))
    port_params = {k[len("encoder."):]: v for k, v in
                   from_jax.tower_state_dict({"encoder": {"transformer": params}}).items()}
    runs = {"trunk": ("seq_trunk", {**TRUNK, "params": port_params, "cases": {
        "plain": {"x": x}, "causal": {"x": x, "bias": np.asarray(jax_causal(16))}}})}
    want = {}
    for label, (over, extra, steps, kw) in {
            "cvap": (CVAP, [], 2, None),
            "gc": (CVAP, ["running.grad_cache.alive=True", "running.grad_cache.chunk_size=4"], 1, None),
            "clap": (CLAP, [], 1, {"retrieval": True})}.items():
        case = "clap" if over is CLAP else "cvap"
        args = _inputs(case, jax_compose(over + JAX_MESH))
        jp, _, w, grads = jax_steps(over, args, kw, steps=steps)
        want[label] = (w, grads)
        runs[label] = ("mesh_steps", {"overrides": over + extra + SEQ + [f"alias_root={root}/{label}"],
                                      "args": args, "params": jp, "spe": SPE, "steps": steps})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = run_ranks(root, "multi", {"runs": runs}, timeout=300)
    return trunk_want, want, got


@pytest.mark.parametrize("name", ["plain", "causal"])
def test_a_stacked_trunk_on_the_ring_matches_the_sequential_one(seq_runs, name):
    """tests/test_sequence_parallel.py:78 and :168: the trunk's tokens split
    over the ring (a causal mask by query rows), its output and its params'
    grads summed over the ring equal JAX's trunk without a mesh."""
    trunk_want, _, got = seq_runs
    y, grads = trunk_want[name]
    for r in got:
        res = r["trunk"][name]
        assert res["rang"]
        _close(res["out"], y, OUT_TOL, f"{name} out")
        for k, g in res["grads"].items():
            _close(g, grads["encoder." + k], GRAD_TOL, k)


@pytest.mark.parametrize("label", ["cvap", "clap"])
def test_a_seq_step_matches_the_jax_global_step(seq_runs, label):
    """tests/test_sequence_parallel.py:242: stacked towers on mesh.seq=2 train
    as the plain step (CLAP: the audio trunk rings, the 77-token text trunk
    runs whole on both ranks and its grads are not summed twice)."""
    _, want, got = seq_runs
    _check_steps([g[label] for g in got], *want[label], steps=len(want[label][0]))


def test_the_grad_cache_composes_with_the_ring(seq_runs):
    """tests/test_sequence_parallel.py:311."""
    _, want, got = seq_runs
    _check_steps([g["gc"] for g in got], *want["gc"], steps=1)


def test_a_trunk_that_does_not_split_warns_and_runs_whole():
    """tests/test_sequence_parallel.py:220 and ``layers.py:528-549``: a token
    count the ring does not divide, or a boolean or non-2-D mask, gives JAX's
    warning and the sequential path (no collective runs)."""
    mesh = Mesh(1, 0, None, "cpu", seq=2)
    assert not sequence.usable(mesh, 15, None)
    assert not sequence.usable(mesh, 16, torch.ones(16, 16, dtype=torch.bool))
    assert not sequence.usable(mesh, 16, torch.zeros(1, 16, 16))
    assert sequence.usable(mesh, 16, torch.zeros(16, 16)) and sequence.usable(mesh, 16, None)
    torch.manual_seed(0)
    tr = Transformer(32, 2, 4)
    for p in tr.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(2, 15, 32)
    want = tr(x)
    tr.stacked, tr.seq = True, mesh
    with pytest.warns(UserWarning, match=r"seq-parallel trunk disqualified \(token count 15 % seq=2"):
        got = tr(x)
    assert not tr.rang and torch.equal(got, want)


def test_seq_does_not_combine_with_model_or_pipe():
    """tests/test_sequence_parallel.py:390 and the trainer's pipe/seq assert:
    refused before any group forms."""
    with pytest.raises(ValueError, match="seq and model"):
        make_mesh(model=2, seq=2)
    with pytest.raises(ValueError, match="mesh.pipe and mesh.seq cannot combine"):
        make_mesh(pipe=2, seq=2)
