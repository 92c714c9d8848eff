"""The port runs without JAX and without the JAX package: a fresh
interpreter imports vipant_tpu_torch, runs the tiny serving slice, the tiny
int8 serving slice, or one tiny training step (with an int8 frozen image
tower too), on the CPU, and never imports jax, jaxlib, flax, optax or any
module of ``vipant_tpu``. A scan of the sources holds the same: no import of
``vipant_tpu`` under ``vipant_tpu_torch/`` or in ``chip_smoke.py``."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import numpy as np
import vipant_tpu_torch
from vipant_tpu_torch.serve import InferenceEngine

eng = InferenceEngine([
    "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
    "+model/text=transformer_val", "+model/loss=ce", "+optimizer=standard",
    "+running/audio=default", "worker=CLAP", "model.image.width=64",
    "model.image.embed_dim=32", "model.image.encoder.layers=2", "model.image.heads=4",
    "model.text.width=64", "model.text.embed_dim=32", "model.text.encoder.layers=2",
    "model.text.heads=4", "running.audio.max_len=100", "model_file=",
], batch_size=4, device="cpu")
fb = np.random.default_rng(0).standard_normal((5, 100, 128)).astype(np.float32)
res = eng.zero_shot(fb, {"dog": ["a dog barking"], "rain": ["rain falling"]})
assert res["scores"].shape == (5, 2) and np.isfinite(res["scores"]).all()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"))
assert not leaked, leaked
print("ok")
"""

INT8_SCRIPT = SCRIPT.replace('batch_size=4, device="cpu")', 'batch_size=4, device="cpu", quantize="int8")')


TRAIN_SCRIPT = """
import sys
import numpy as np
from vipant_tpu_torch.train import Trainer

tr = Trainer([
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "worker=CVAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "running.batch_size=4", "optimizer.warmup_epoch=0",
] + EXTRA, device="cpu")
r = np.random.default_rng(0)
batch = tr.make_batch(r.standard_normal((4, 3, 224, 224)).astype(np.float32),
                      r.standard_normal((4, 1, 100, 128)).astype(np.float32))
before = {k: p.detach().clone() for k, p in tr.trainable.items()}
m = tr.train_step(*batch)
assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0 and m["lr"] > 0
assert any(not (p.detach() == before[k]).all() for k, p in tr.trainable.items())
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"))
assert not leaked, leaked
print("ok")
"""


def _run(script):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


def test_port_never_imports_jax():
    _run(SCRIPT)


def test_port_serves_int8_without_jax():
    assert INT8_SCRIPT != SCRIPT
    _run(INT8_SCRIPT)


def test_port_trains_without_jax():
    _run("EXTRA = []" + TRAIN_SCRIPT)


def test_port_trains_with_int8_frozen_without_jax():
    _run('EXTRA = ["model.image.int8_frozen=True"]' + TRAIN_SCRIPT)


def test_entry_points_default_to_the_card_and_raise_without_one():
    _run("""
import torch
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer
assert not torch.cuda.is_available()
for make in (lambda: InferenceEngine(["worker=CLAP"]), lambda: Trainer(["worker=CVAP"])):
    try:
        make()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("no CUDA device, and the entry point carried on")
print("ok")
""")


IMPORT_OF_JAX_PACKAGE = re.compile(r"^\s*(import|from)\s+vipant_tpu(\.|\s)", re.M)


def test_no_source_of_the_port_imports_the_jax_package():
    assert IMPORT_OF_JAX_PACKAGE.search("from vipant_tpu.config import compose")
    assert IMPORT_OF_JAX_PACKAGE.search("    import vipant_tpu\n")
    assert not IMPORT_OF_JAX_PACKAGE.search("from vipant_tpu_torch.config import compose")
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "vipant_tpu_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(sources) > 30
    for path in sources:
        with open(path) as fh:
            text = fh.read()
        hit = IMPORT_OF_JAX_PACKAGE.search(text)
        assert hit is None, f"{os.path.relpath(path, ROOT)}: {hit.group(0).strip()!r}"
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax)\b", text, re.M), path
