"""The port's model-parallel serving (``InferenceEngine(model_parallel=N)``,
its server and its command line) against the JAX package on the CPU,
mirroring tests/test_serve.py:574.

The JAX engines run in this process on one device; the port's engines on 2
gloo ranks (tests/torch_dist_worker.py), each holding its model rank's
slices of the JAX engine's weights. fp32: every rank's embeddings within
atol 1e-4 of the JAX engine's (tests/test_torch_serve.py's fp32 bound),
greedy captions equal; int8: each rank quantizes its own slices, per-row
cosine >= 0.99 to the bf16 embeddings.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from vipant_tpu.serve import InferenceEngine as JaxEngine

from test_torch_captioning import CAPTION_TINY
from test_torch_serve import CLASSES, TEXTS, TINY
from torch_dist_worker import LAUNCH_ENV, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    fb = np.random.default_rng(9).standard_normal((6, 100, 128)).astype(np.float32)
    clap = TINY + ["compute_dtype=float32"]
    jeng = JaxEngine(clap, batch_size=4)
    params = {k: v for k, v in _np(jeng.variables["params"]).items() if k in ("audio", "text", "loss")}
    cap = CAPTION_TINY + ["compute_dtype=float32", "eval=True"]
    jcap = JaxEngine(cap, batch_size=4)
    want = {"audio": jeng.embed_audio(fb), "texts": jeng.embed_texts(TEXTS, prompt="the sound of "),
            "zero_shot": np.asarray(jeng.zero_shot(fb, CLASSES)["scores"]),
            "caption": jcap.caption(fb)}
    bf16 = TINY + ["compute_dtype=bfloat16"]
    engines = {
        "fp32": {"cfg": clap, "params": params, "fb": fb, "texts": TEXTS, "classes": CLASSES,
                 "server": True},
        "caption": {"cfg": cap, "params": _np(jcap.variables["params"]), "caption": fb},
        "bf16": {"cfg": bf16, "params": params, "fb": fb, "texts": TEXTS},
        "int8": {"cfg": bf16, "params": params, "fb": fb, "texts": TEXTS, "quantize": "int8"},
    }
    got = run_ranks(tmp_path_factory.mktemp("mp"), "mp_engine", {"engines": engines}, timeout=300)
    return want, got


def test_a_model_parallel_engine_gives_every_rank_the_one_device_embeddings(mp):
    want, got = mp
    for r in got:
        for key in ("audio", "texts", "zero_shot"):
            np.testing.assert_allclose(r["fp32"][key], want[key], atol=1e-4, rtol=0, err_msg=key)
    assert any("attn.in_proj_weight" in k for k in got[0]["fp32"]["splits"])
    assert "text.pre_encoder.token_embedding.weight" in got[0]["fp32"]["splits"]


def test_a_model_parallel_engine_captions_as_one_device(mp):
    want, got = mp
    for r in got:
        assert r["caption"]["caption"] == want["caption"]


def test_the_int8_model_parallel_engine_quantizes_each_ranks_slices(mp):
    _, got = mp
    for r in got:
        for key in ("audio", "texts"):
            a, b = r["int8"][key], r["bf16"][key]
            cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
            assert cos.min() >= 0.99, (key, cos)
    assert np.array_equal(got[0]["int8"]["audio"], got[1]["int8"]["audio"])


def test_the_server_leads_and_the_other_ranks_follow(mp):
    """Rank 0's HTTP server broadcasts each request's route and inputs; the
    other rank makes the same call (its collectives meet rank 0's)."""
    want, got = mp
    np.testing.assert_array_equal(got[0]["fp32"]["http"], got[0]["fp32"]["texts"])
    np.testing.assert_allclose(got[0]["fp32"]["http"], want["texts"], atol=1e-4, rtol=0)
    assert got[1]["fp32"]["followed"] == 1


def test_the_command_line_serves_under_torchrun_with_model_parallel(tmp_path):
    """``torchrun --nproc_per_node=2 -m vipant_tpu_torch.serve --model_parallel
    2 --task embed_text``: both ranks run the task, rank 0 writes the output,
    which equals one process's; a launcher of 2 ranks without
    ``--model_parallel 2`` is refused."""
    over = TINY + ["compute_dtype=float32", "platform=cpu"]
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")

    def run(*launcher, mp_n=1, out="x.npz"):
        cmd = [*launcher, "-m", "vipant_tpu_torch.serve", "--task", "embed_text", "--texts",
               "a dog barking;heavy rain", "--batch_size", "4", "--output", str(tmp_path / out),
               "--model_parallel", str(mp_n), "--", *over]
        return subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                              timeout=240)

    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2"]
    two = run(*torchrun, mp_n=2, out="two.npz")
    assert two.returncode == 0, (two.stdout[-3000:], two.stderr[-3000:])
    one = run(sys.executable, out="one.npz")
    assert one.returncode == 0, one.stderr[-3000:]
    a, b = np.load(tmp_path / "two.npz"), np.load(tmp_path / "one.npz")
    np.testing.assert_allclose(a["embeddings"], b["embeddings"], atol=1e-5, rtol=0)
    assert list(a["names"]) == ["a dog barking", "heavy rain"]
    assert two.stdout.count(f"wrote {tmp_path / 'two.npz'}") == 1  # rank 0 alone
    refused = run(*torchrun, out="no.npz")
    assert refused.returncode != 0 and "serves only with --model_parallel 2" in refused.stdout + refused.stderr
    assert not (tmp_path / "no.npz").exists()
