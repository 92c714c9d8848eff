"""The port runs without JAX: a fresh interpreter imports vipant_tpu_torch,
runs the tiny serving slice on the CPU, and never imports jax or flax."""

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
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not leaked, leaked
print("ok")
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")
