"""The port runs without JAX and without the JAX package: a fresh
interpreter imports vipant_tpu_torch, runs the tiny serving slice, the tiny
int8 serving slice, one tiny training step (with an int8 frozen image
tower too), a tiny captioning step and ``caption`` call (bf16 and int8),
``Trainer.learn`` over two epochs of a synthetic JSONL index (written by
``chip_smoke.write_synthetic_va``) with its checkpoints and a bitwise
resume, a pak VA run (the packing CLI, then a training epoch on the pack)
and a ``CVALP`` step with tied stages, or an epoch with the device frontend (int16 waveforms, uint8
frames) followed by the file entry points and a request to the HTTP server,
on the CPU, or an engine seeded from a CLIP file with a training step
whose save writes a reference ``.pth`` that a second engine serves, or a
ResNet, a meme-seeded DeiT and a patchout ViT step saved asynchronously and
served, and
never imports jax, jaxlib, flax, optax or any module of ``vipant_tpu``; the
command lines ``python -m vipant_tpu_torch
platform=cpu`` (an ``LAMonitor`` step; docs/recipes.md's ESC-50 zero-shot
and x-fold and AudioSet recipes) and ``python -m vipant_tpu_torch.serve``
run where importing any of them raises, and so do two gloo ranks training
with ZeRO-1 and the gradient cache. A scan of the sources holds the same:
no import of ``vipant_tpu`` under ``vipant_tpu_torch/`` (``parallel/`` too),
in ``chip_smoke.py`` or in ``tests/torch_dist_worker.py``. The data layer, with the native fbank, imports no torch
(its spawned workers start without it)."""

import os
import re
import subprocess
import sys

import pytest

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


CAPTION_SCRIPT = """
import sys
import numpy as np
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer

cfg = [
    "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
    "+model/text=transformer_decoder", "+model/loss=ce_lm", "+optimizer=standard",
    "+running/audio=default", "model.audio.pre_encoder.stride=[16,24]",
    "running.audio.max_len=100", "worker=CLAP", "model.image.width=64",
    "model.image.embed_dim=32", "model.image.encoder.layers=2", "model.image.heads=4",
    "model.text.width=32", "model.text.heads=4", "model.text.layers=2", "model.text.mem_width=64",
    "model.text.max_len_dec=8", "model.text.embed_dim=32", "running.retrieval=False",
    "model_file=",
]
r = np.random.default_rng(0)
fb = r.standard_normal((3, 100, 128)).astype(np.float32)
tr = Trainer(cfg + ["running.batch_size=3", "optimizer.warmup_epoch=0"], device="cpu")
ids = np.zeros((3, 77), np.int64)
ids[:, 0], ids[:, 1:5], ids[:, 5] = 49406, r.integers(1, 49406, (3, 4)), 49407
before = {k: p.detach().clone() for k, p in tr.trainable.items()}
m = tr.train_step(*tr.make_batch(fb[:, None], ids))
assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0 and m["lr"] > 0
assert any(not (p.detach() == before[k]).all() for k, p in tr.trainable.items())
eng = InferenceEngine(cfg, batch_size=2, device="cpu" QUANTIZE)
for beam in (0, 3):
    out = eng.caption(fb, beam=beam)
    assert len(out) == 3 and all(isinstance(c, str) for c in out), out
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"))
assert not leaked, leaked
print("ok")
"""


LEARN_SCRIPT = """
import os, sys, tempfile
import torch
import chip_smoke
from vipant_tpu_torch.train import Trainer

root = tempfile.mkdtemp()
chip_smoke.write_synthetic_va(root, "train", 8, seconds=1.05, frame_size=64)
chip_smoke.write_synthetic_va(root, "val", 3, seconds=1.05, frame_size=64, seed=1)
cfg = [
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "worker=CVAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "model.image.token_pack=4", "optimizer.warmup_epoch=0",
    f"running.data_root={root}", "running.data_name=train", "running.eval_name=val",
    "running.batch_size=4", "running.epochs=2", "running.save_rate=3", "eval=False",
    "loader_backend=process", "num_proc=2", f"alias_root={root}/run", f"model_root={root}/run",
    "model_name=m",
]
a = Trainer(cfg, device="cpu")
a.learn()
step = os.path.join(root, "run", "m", "00000003")
assert a.global_step == 4 and sorted(os.listdir(step)) == [
    "COMMITTED", "config.json", "model.npz", "state.pt"], os.listdir(step)
b = Trainer(cfg + ["model_file=00000003"], device="cpu")
assert b.global_step == 3
b.learn()
assert all(torch.equal(p, b.trainable[k]) for k, p in a.trainable.items())
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"))
assert not leaked, leaked
print("ok")
"""


PAK_SCRIPT = """
import os, subprocess, sys, tempfile
import numpy as np
import chip_smoke
from vipant_tpu_torch.train import Trainer, build_monitor

root = tempfile.mkdtemp()
chip_smoke.write_synthetic_va(root, "train", 8, seconds=1.05, frame_size=64, npz_name="npz_train",
                              frames_npz=110)
tiny = [
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "worker=CVAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "optimizer.warmup_epoch=0", f"running.data_root={root}",
    "running.audio.ship_bf16=True", "running.image_uint8=True", "running.batch_size=4",
]
subprocess.run([sys.executable, "-m", "vipant_tpu_torch.data.packed", *tiny,
                "running.data_name=npz_train", "pack.len=110", "pack.out=pak_train"], check=True)
tr = Trainer(tiny + ["running.data_name=pak_train", "running.eval_name=pak_train", "running.epochs=1",
                     "eval=False", f"alias_root={root}/run", f"model_root={root}/run"], device="cpu")
tr.learn()
assert tr.global_step == 2 and "I->A" in tr.infer(tr.evalloader)
val = build_monitor([
    "+running=trimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=transformer_val",
    "+model/loss=ce_val", "+optimizer=standard", "+running/audio=default", "worker=CVALP",
    "monitor=VALMonitor", "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "model.text.width=32", "model.text.heads=4", "model.text.encoder.layers=2",
    "running.label_map=", "running.siamese.alive=True", "running.siamese.amodules=[encoder,misc]",
    f"alias_root={root}/run", f"model_root={root}/run", "model_file=",
], device="cpu", steps_per_epoch=10)
r = np.random.default_rng(0)
ids = np.zeros((4, 77), np.int32)
ids[:, 0], ids[:, 1:4], ids[:, 4] = 49406, r.integers(1, 49406, (4, 3)), 49407
m = val.train_step(*val.make_batch(r.standard_normal((4, 3, 224, 224)).astype(np.float32),
                                   r.standard_normal((4, 1, 100, 128)).astype(np.float32), ids))
assert np.isfinite(float(m["loss"])) and sorted(k for k in m if k.startswith("loss_")) == [
    "loss_al", "loss_va"], m
assert val.model.audio.encoder.resblocks[0].ln_1.weight is val.model.image.encoder.resblocks[0].ln_1.weight
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"))
assert not leaked, leaked
print("ok")
"""


FRONTEND_SCRIPT = """
import glob, json, os, sys, tempfile, threading, urllib.request
import numpy as np
import chip_smoke
from vipant_tpu_torch.serve import InferenceEngine, make_server
from vipant_tpu_torch.train import Trainer

root = tempfile.mkdtemp()
chip_smoke.write_synthetic_va(root, "train", 8, seconds=0.8, frame_size=64)
model = [
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "worker=CVAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4",
]
tr = Trainer(model + [
    "optimizer.warmup_epoch=0", f"running.data_root={root}", "running.data_name=train",
    "running.eval_name=train", "running.batch_size=4", "running.epochs=1", "eval=False",
    "loader_backend=process", "num_proc=2", f"alias_root={root}/run", f"model_root={root}/run",
    "model_name=m", "running.audio.on_device=True", "running.audio.wav_int16=True",
    "running.image_uint8=True"], device="cpu")
tr.learn()
assert tr.global_step == 2 and "I->A" in tr.infer(tr.evalloader)
tr.close()
eng = InferenceEngine(model, batch_size=4, device="cpu")
wavs = sorted(glob.glob(os.path.join(root, "aclip", "*.wav")))
emb = eng.embed_audio_files(wavs)
assert emb.shape == (8, 32) and eng.embed_image_files(
    sorted(glob.glob(os.path.join(root, "frame", "*.jpg")))).shape == (8, 32)
srv = make_server(eng, port=0)
threading.Thread(target=srv.serve_forever, daemon=True).start()
try:
    with open(wavs[0], "rb") as f:
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/embed_audio",
                                     data=f.read(), headers={"Content-Type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert np.allclose(json.loads(r.read())["embeddings"], emb[:1], atol=1e-6)
finally:
    srv.shutdown()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"))
assert not leaked, leaked
print("ok")
"""


CKPT_SCRIPT = """
import os, sys
import numpy as np
import torch
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer

root, clip = ROOT_DIR, CLIP_FILE
model = [
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "worker=CVAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", f"running.clip_model_root={os.path.dirname(clip)}",
    "running.clip_model_name=tinyclip",
]
sd = torch.load(clip)
eng = InferenceEngine(model, batch_size=4, device="cpu")
assert torch.equal(eng.model.image.pre_encoder.conv1.weight, sd["visual.conv1.weight"])
tr = Trainer(model + ["running.batch_size=2", "optimizer.warmup_epoch=0", "export_pth=True",
                      f"alias_root={root}", "model_name=m"], device="cpu")
assert torch.equal(tr.frozen["image.misc.class_embedding"], sd["visual.class_embedding"])
r = np.random.default_rng(0)
tr.train_step(*tr.make_batch(r.standard_normal((2, 3, 224, 224)).astype(np.float32),
                             r.standard_normal((2, 1, 100, 128)).astype(np.float32)))
step = tr.save()
eng2 = InferenceEngine(model + [f"model_file={os.path.join(step, '00000000.pth')}"], batch_size=4,
                       device="cpu")
fb = r.standard_normal((3, 100, 128)).astype(np.float32)
with torch.no_grad():
    want = tr.model.encode_audio(torch.from_numpy(fb[:, None]), train=False).float().numpy()
assert np.abs(eng2.embed_audio(fb) - want).max() < 1e-5
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"))
assert not leaked, leaked
print("ok")
"""


BACKBONE_SCRIPT = """
import os, sys, tempfile
import numpy as np
import torch
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer
from vipant_tpu_torch.train.checkpoint import wait_for_saves

root = tempfile.mkdtemp()
base = ["+running=bimodal", "+model/text=dummy", "+model/loss=ce", "+optimizer=standard",
        "+running/audio=default", "worker=CVAP", "optimizer.warmup_epoch=0",
        f"alias_root={root}", f"model_root={root}", "model_name=m", "async_ckpt=True"]
rn = ["+model/image=rn50_val", "+model/audio=rn50_val", "model.image.width=16",
      "model.image.embed_dim=32", "model.image.encoder.layers=[1,1,1,1]", "model.image.heads=8",
      "model.audio.heads=8", "model.image.resolution=64", "running.audio.max_len=96"]
w = 64
sd = {"pos_embed": torch.randn(1, 6, w), "cls_token": torch.randn(1, 1, w),
      "dist_token": torch.randn(1, 1, w), "patch_embed.proj.weight": torch.randn(w, 3, 16, 16),
      "patch_embed.proj.bias": torch.randn(w), "norm.weight": torch.ones(w), "norm.bias": torch.zeros(w)}
for k, shape in (("attn.qkv.weight", (3 * w, w)), ("attn.qkv.bias", (3 * w,)), ("attn.proj.weight", (w, w)),
                 ("attn.proj.bias", (w,)), ("norm1.weight", (w,)), ("norm1.bias", (w,)),
                 ("norm2.weight", (w,)), ("norm2.bias", (w,)), ("mlp.fc1.weight", (4 * w, w)),
                 ("mlp.fc1.bias", (4 * w,)), ("mlp.fc2.weight", (w, 4 * w)), ("mlp.fc2.bias", (w,))):
    sd[f"blocks.0.{k}"] = 0.05 * torch.randn(*shape)
torch.save(sd, os.path.join(root, "deit.pth"))
deit = ["+model/image=deit", "+model/audio=deit", "model.image.resolution=32", "model.image.embed_dim=32",
        "running.audio.max_len=64", f"model.image.meme_path={root}/deit.pth",
        f"model.audio.meme_path={root}/deit.pth",
        *[f"model.{t}.{k}={v}" for t in ("image", "audio") for k, v in (("width", w), ("layers", 1), ("heads", 4))]]
vit = ["+model/image=vit_val", "+model/audio=vit_val", "model.audio.pre_encoder.stride=[16,24]",
       "running.audio.max_len=100", "model.image.width=64", "model.image.embed_dim=32",
       "model.image.encoder.layers=1", "model.image.heads=4", "model.audio.patchout=0.25"]
r = np.random.default_rng(0)
for over, res in ((rn, 64), (deit, 32), (vit, 224)):
    tr = Trainer(base + over + ["model_file="], device="cpu", steps_per_epoch=10)
    cfg = tr.cfg
    batch = tr.make_batch(r.standard_normal((4, 3, res, res)).astype(np.float32),
                          r.standard_normal((4, 1, *cfg.model.audio.resolution)).astype(np.float32))
    m = tr.train_step(*batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    tr.global_step = tr.state.step
    tr.save()
    wait_for_saves()
    eng = InferenceEngine(base + over + ["model_file=00000001"], batch_size=4, device="cpu")
    assert np.isfinite(eng.embed_audio(r.standard_normal((2, *cfg.model.audio.resolution)).astype(np.float32))).all()
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


def test_port_learns_from_an_index_and_resumes_without_jax():
    _run(LEARN_SCRIPT)


def test_port_packs_trains_on_a_pack_and_steps_cvalp_without_jax():
    _run(PAK_SCRIPT)


def test_port_runs_the_device_frontend_and_serves_files_without_jax():
    _run(FRONTEND_SCRIPT)


def test_port_loads_clip_and_writes_a_pth_without_jax(tmp_path):
    """An engine and a trainer seeded from a CLIP file (tests/torch_oracle.py's
    state dict), a step whose save writes the reference ``.pth``, and an
    engine serving that file."""
    import torch
    from torch_oracle import TorchText, TorchVisual, clip_state_dict

    torch.manual_seed(0)
    torch.save(clip_state_dict(TorchVisual(width=64, layers=2, heads=4, embed_dim=32),
                               TorchText(width=64, layers=2, heads=4, embed_dim=32)),
               tmp_path / "tinyclip.pt")
    _run(CKPT_SCRIPT.replace("ROOT_DIR", repr(str(tmp_path))).replace(
        "CLIP_FILE", repr(str(tmp_path / "tinyclip.pt"))))


def test_the_data_layer_imports_no_torch():
    _run("""
import sys
import vipant_tpu_torch.data
from vipant_tpu_torch import native
from vipant_tpu_torch.data import (audio_text, audioset, esc50, image_audio, image_text, packed,
                                   transforms_audio, transforms_image)
from vipant_tpu_torch.ops import fbank_np, mel
assert native.native_available()
assert "torch" not in sys.modules, "the data layer imported torch"
print("ok")
""")


def test_serving_cli_runs_without_jax(tmp_path):
    """``python -m vipant_tpu_torch.serve --task embed_audio ... platform=cpu``
    where importing jax, jaxlib, flax, optax or vipant_tpu raises."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    import numpy as np

    chip_smoke.write_synthetic_va(str(tmp_path / "d"), "train", 3, seconds=0.8, frames=False)
    blocked = tmp_path / "blocked"
    for name in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"):
        (blocked / name).mkdir(parents=True)
        (blocked / name / "__init__.py").write_text(f"raise ImportError('{name} must not be imported')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(blocked), ROOT]))
    out = tmp_path / "e.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "vipant_tpu_torch.serve", "--task", "embed_audio",
         "--inputs", str(tmp_path / "d" / "aclip" / "*.wav"), "--output", str(out),
         "--batch_size", "2", "--", *CLI_ARGS[:21], "running.audio.max_len=100"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert np.load(out)["embeddings"].shape == (3, 32) and "wrote" in proc.stdout


def test_port_trains_and_serves_the_other_backbones_without_jax():
    """A ResNet, a meme-seeded DeiT and a patchout ViT VA step, each saved
    asynchronously and served from its step directory."""
    _run(BACKBONE_SCRIPT)


def test_port_serves_int8_without_jax():
    assert INT8_SCRIPT != SCRIPT
    _run(INT8_SCRIPT)


def test_port_trains_without_jax():
    _run("EXTRA = []" + TRAIN_SCRIPT)


def test_port_trains_with_int8_frozen_without_jax():
    _run('EXTRA = ["model.image.int8_frozen=True"]' + TRAIN_SCRIPT)


def test_port_trains_and_serves_captioning_without_jax():
    _run(CAPTION_SCRIPT.replace(" QUANTIZE", ""))


def test_port_serves_int8_captioning_without_jax():
    _run(CAPTION_SCRIPT.replace(" QUANTIZE", ', quantize="int8"'))


DP_SCRIPT = """
import sys, tempfile
import numpy as np
sys.path.insert(0, TESTS)
from torch_dist_worker import run_ranks
from vipant_tpu_torch.serve import InferenceEngine

over = ["+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
        "+model/loss=ce", "+optimizer=standard", "+running/audio=default", "worker=CVAP",
        "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "model.image.width=64",
        "model.image.embed_dim=32", "model.image.encoder.layers=1", "model.image.heads=4",
        "running.batch_size=4", "model_file=", "mesh.zero=True", "running.grad_cache.alive=True",
        "running.grad_cache.chunk_size=2"]
r = np.random.default_rng(0)
args = [r.standard_normal((4, 3, 224, 224)).astype(np.float32),
        r.standard_normal((4, 1, 100, 128)).astype(np.float32)]
got = run_ranks(tempfile.mkdtemp(), "steps", {"overrides": over, "args": args}, timeout=240)
assert [g["mesh"] for g in got] == [(0, 2, "gloo"), (1, 2, "gloo")]
assert got[0]["grad_cache"] == (("encode_image", "encode_audio"), 2)
assert all(np.isfinite(s["loss"]) for g in got for s in g["steps"])
eng = InferenceEngine(over, batch_size=2, device="cpu", data_parallel=True)
assert len(eng.replicas) == 1
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"))
assert not leaked, leaked
print("ok")
"""


def test_port_trains_on_two_ranks_with_zero_and_the_grad_cache_without_jax(tmp_path):
    """Two gloo ranks (tests/torch_dist_worker.py) train a tiny VA step with
    ZeRO-1 and the gradient cache, and a data-parallel engine builds, where
    importing jax, jaxlib, flax, optax or vipant_tpu raises in the parent and
    in both ranks."""
    blocked = tmp_path / "blocked"
    for name in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"):
        (blocked / name).mkdir(parents=True)
        (blocked / name / "__init__.py").write_text(f"raise ImportError('{name} must not be imported')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(blocked), ROOT]))
    script = DP_SCRIPT.replace("TESTS", repr(os.path.join(ROOT, "tests")))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


AXES_SCRIPT = """
import sys, tempfile
import numpy as np
sys.path.insert(0, TESTS)
from torch_dist_worker import run_ranks

over = ["+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
        "+model/loss=ce", "+optimizer=standard", "+running/audio=default", "worker=CVAP",
        "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "model.image.width=64",
        "model.image.embed_dim=32", "model.image.encoder.layers=2", "model.image.heads=4",
        "running.batch_size=4", "model_file=", "mesh.data=-1"]
r = np.random.default_rng(0)
args = [r.standard_normal((4, 3, 224, 224)).astype(np.float32),
        r.standard_normal((4, 1, 100, 128)).astype(np.float32)]
runs = {axis: ("mesh_steps", {"overrides": over + [f"mesh.{axis}=2"], "args": args, "steps": 1})
        for axis in ("model", "pipe", "seq")}
got = run_ranks(tempfile.mkdtemp(), "multi", {"runs": runs}, timeout=240)
for axis in runs:
    assert [g[axis]["shape"][axis] for g in got] == [2, 2]
    assert got[0][axis]["steps"][0]["loss"] == got[1][axis]["steps"][0]["loss"]
    assert np.isfinite(got[0][axis]["steps"][0]["loss"])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"))
assert not leaked, leaked
print("ok")
"""


def test_port_trains_on_the_model_pipe_and_seq_axes_without_jax(tmp_path):
    """Two gloo ranks train a tiny VA step on mesh.model=2, mesh.pipe=2 and
    mesh.seq=2, where importing jax, jaxlib, flax, optax or vipant_tpu
    raises in the parent and in both ranks."""
    blocked = tmp_path / "blocked"
    for name in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"):
        (blocked / name).mkdir(parents=True)
        (blocked / name / "__init__.py").write_text(f"raise ImportError('{name} must not be imported')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(blocked), ROOT]))
    script = AXES_SCRIPT.replace("TESTS", repr(os.path.join(ROOT, "tests")))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


CLI_ARGS = [
    "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=transformer_val",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default", "worker=CLAP",
    "monitor=LAMonitor", "platform=cpu", "model.image.width=64", "model.image.embed_dim=32",
    "model.image.encoder.layers=2", "model.image.heads=4", "model.audio.width=64",
    "model.audio.encoder.layers=2", "model.audio.heads=4", "model.audio.pre_encoder.stride=[16,24]",
    "model.text.width=64", "model.text.encoder.layers=2", "model.text.heads=4",
    "running.audio.max_len=100", "running.data_name=clotho_train", "running.eval_name=clotho_val",
    "running.test_name=", "running.batch_size=2", "running.epochs=1", "running.save_epoch=True",
    "running.peep_rate=1", "eval=False", "loader_backend=thread", "num_proc=1", "model_name=cli",
]


def test_cli_trains_an_la_monitor_step_without_jax(tmp_path):
    """``python -m vipant_tpu_torch platform=cpu ...``: one LAMonitor step on
    a synthetic Clotho index (``chip_smoke.write_synthetic_clotho``), its
    save and its eval, in an interpreter where importing jax, jaxlib, flax,
    optax or vipant_tpu raises."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    data, blocked = tmp_path / "data", tmp_path / "blocked"
    chip_smoke.write_synthetic_clotho(str(data), "clotho_train", 2, seconds=1.05)
    chip_smoke.write_synthetic_clotho(str(data), "clotho_val", 2, seconds=1.05, seed=1)
    for name in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"):
        (blocked / name).mkdir(parents=True)
        (blocked / name / "__init__.py").write_text(f"raise ImportError('{name} must not be imported')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(blocked), ROOT]))
    proc = subprocess.run([sys.executable, "-m", "vipant_tpu_torch", *CLI_ARGS,
                           f"running.data_root={data}", f"alias_root={tmp_path}/run",
                           f"model_root={tmp_path}/run"],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    run = tmp_path / "run" / "cli"
    assert sorted(os.listdir(run / "00000001")) == ["COMMITTED", "config.json", "model.npz", "state.pt"]
    log = (run / "train_0.out").read_text()
    assert "on cpu" in proc.stdout
    assert "epoch 0 step 1 loss" in log and "A->T: t1 = " in log, log[-2000:]


CLF_TINY = [
    "+model/image=vit_val", "+model/audio=vit_val", "+model/text=transformer_val",
    "+optimizer=standard", "+running/audio=default", "platform=cpu", "model.image.width=64",
    "model.image.embed_dim=32", "model.image.encoder.layers=2", "model.image.heads=4",
    "model.text.width=32", "model.text.heads=4", "model.text.encoder.layers=2",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "running.batch_size=4",
    "running.peep_rate=1", "loader_backend=thread", "num_proc=2",
]
# docs/recipes.md's classification recipes, at the tiny widths: (overrides, what the log must say)
CLF_RECIPES = {
    "esc50_zero_shot": (["+running=esc50", "+model/loss=ce_cls", "worker=ESClassifier",
                         "monitor=ESCMonitor", "running.zero_shot=True", "eval=True"], "A->T: p1 = "),
    "esc50_xfold": (["+running=esc50", "+model/loss=ce_cls", "worker=ESClassifier",
                     "monitor=ESCMonitor", "running.zero_shot=False", "eval=False", "running.epochs=1"],
                    "Best mean and std: "),
    "audioset": (["+running=audioset", "+model/loss=imagine_and_classify", "worker=ASClassifier",
                  "monitor=ASMonitor", "eval=False", "running.mixup_rate=0.5",
                  "running.weighted_sampling=True", "running.data_name=as_train",
                  "running.eval_name=as_eval", "running.test_name=as_eval", "running.epochs=1",
                  "running.save_rate=2"], "TEST Mac-AP = "),
}


@pytest.mark.parametrize("recipe", sorted(CLF_RECIPES))
def test_cli_runs_the_classification_recipes_without_jax(tmp_path, recipe):
    """``python -m vipant_tpu_torch`` on docs/recipes.md's ESC-50 zero-shot and
    x-fold and AudioSet recipes (tiny widths, on the CPU) over
    ``chip_smoke.write_synthetic_esc50`` / ``write_synthetic_audioset`` data,
    where importing jax, jaxlib, flax, optax or vipant_tpu raises."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    data, blocked = tmp_path / "data", tmp_path / "blocked"
    if recipe.startswith("esc50"):
        chip_smoke.write_synthetic_esc50(str(data), folds=2, seconds=1.05,
                                         classes=chip_smoke.ESC_CLASSES[:4])
    else:
        chip_smoke.write_synthetic_audioset(str(data), train=8, evals=4, labels=12, seconds=1.05)
    for name in ("jax", "jaxlib", "flax", "optax", "vipant_tpu"):
        (blocked / name).mkdir(parents=True)
        (blocked / name / "__init__.py").write_text(f"raise ImportError('{name} must not be imported')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(blocked), ROOT]))
    over, says = CLF_RECIPES[recipe]
    proc = subprocess.run([sys.executable, "-m", "vipant_tpu_torch", *over, *CLF_TINY,
                           f"running.data_root={data}", f"alias_root={tmp_path}/run",
                           f"model_root={tmp_path}/run", "model_name=clf"],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    log = (tmp_path / "run" / "clf" / "train_0.out").read_text()
    assert says in log, log[-2000:]
    if recipe == "audioset":
        assert re.search(r"step 1 loss \S+ \(avg \S+\) bce \S+ ce \S+ ", log), log[-2000:]


def test_entry_points_default_to_the_card_and_raise_without_one():
    _run("""
import torch
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer
assert not torch.cuda.is_available()
from vipant_tpu_torch.train import build_monitor
for make in (lambda: InferenceEngine(["worker=CLAP"]), lambda: Trainer(["worker=CVAP"]),
             lambda: build_monitor(["+running=clotho", "worker=CLAP", "monitor=LAMonitor"])):
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
    sources = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "torch_dist_worker.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "vipant_tpu_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(sources) > 35
    assert any(p.endswith(os.path.join("experiments", "fused_block_probe.py")) for p in sources)
    assert any(p.endswith(os.path.join("nn", "seqgen.py")) for p in sources)
    for new in (("ops", "fbank.py"), ("ops", "specaugment.py"), ("ops", "frontend.py"),
                ("ckpt", "clip_port.py"), ("ckpt", "reference_port.py"),
                ("ckpt", "reference_export.py"), ("ckpt", "loading.py"), ("ckpt", "zoo.py"),
                ("native", "__init__.py"), ("data", "esc50.py"), ("data", "audioset.py"),
                ("data", "packed.py"), ("data", "image_text.py"), ("nn", "tying.py"),
                ("nn", "resnet.py"), ("nn", "deit.py"), ("ckpt", "deit_port.py"),
                ("experiments", "deit_grad_gap.py"), ("parallel", "__init__.py"),
                ("parallel", "mesh.py"), ("parallel", "collectives.py"), ("parallel", "zero.py"),
                ("parallel", "grad_cache.py"), ("parallel", "tensor.py"), ("parallel", "pipeline.py"),
                ("parallel", "sequence.py"), ("tests", "torch_dist_worker.py")):
        assert any(p.endswith(os.path.join(*new)) for p in sources), new
    for path in sources:
        with open(path) as fh:
            text = fh.read()
        hit = IMPORT_OF_JAX_PACKAGE.search(text)
        assert hit is None, f"{os.path.relpath(path, ROOT)}: {hit.group(0).strip()!r}"
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax)\b", text, re.M), path
