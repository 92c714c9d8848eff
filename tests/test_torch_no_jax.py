"""The port runs without JAX: a fresh interpreter imports vipant_tpu_torch,
runs the tiny serving slice, or one tiny training step, on the CPU, and
never imports jax, jaxlib, flax or optax."""

import os
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
], batch_size=4)
fb = np.random.default_rng(0).standard_normal((5, 100, 128)).astype(np.float32)
res = eng.zero_shot(fb, {"dog": ["a dog barking"], "rain": ["rain falling"]})
assert res["scores"].shape == (5, 2) and np.isfinite(res["scores"]).all()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("ok")
"""


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
])
r = np.random.default_rng(0)
batch = tr.make_batch(r.standard_normal((4, 3, 224, 224)).astype(np.float32),
                      r.standard_normal((4, 1, 100, 128)).astype(np.float32))
before = {k: p.detach().clone() for k, p in tr.trainable.items()}
m = tr.train_step(*batch)
assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0 and m["lr"] > 0
assert any(not (p.detach() == before[k]).all() for k, p in tr.trainable.items())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
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


def test_port_trains_without_jax():
    _run(TRAIN_SCRIPT)
