"""The port's packed shards (vipant_tpu_torch/data/packed.py) and the
loader's one-gather batch path against the JAX package, on the CPU, at a
small size, both packages on the NumPy fbank (tests/fbank_route.py):

- files: each port packer writes the JAX packer's bytes on the same
  synthetic index (``audio.npy``, ``image.npy``, ``lengths.npy``,
  ``text.npy``, ``n_caps.npy``, ``label.npy``, ``image_emb.npy``,
  ``meta.json``, ``names.json``): npz and wav rows, ``tile_audio``, clips
  shorter than the pack, ``pack_len`` above and below ``max_len``;
- batches: a pack written by either package gives bitwise the same
  ``get_batch`` output in both (the JAX bf16 audio read as its uint16 bits)
  for the same ``(idxs, seed)``, train (crops, SpecAugment masks, caption
  picks) and eval, for all three kinds, ``np_rnd`` under one seed of the
  global RNG, and the items under one seed of it; the port's ``DataLoader``
  yields the JAX loader's batches bitwise over an epoch on the thread and
  the process backends, and after a mid-epoch resume;
- guards: every refusal of the JAX package (version, kind, norms,
  ``ship_bf16``, ``image_uint8``, prompt, mixup, label-map order, ``clf``,
  the AT pack's context) raises the same error in the port;
- the AudioSet branch: the filter set applied before the eval cap, and the
  weighted sampler's weights, equal the JAX package's; a pickled pack is
  under 1 MB and reopens its mmaps; the CLI packs all three kinds;
- loops: the VA, AT and AudioSet trainers on a pack (LARS, 4 steps, the
  thread loader) match the JAX trainers' losses within rtol 1e-4 and their
  final trainable params within atol 1e-5 (tests/test_torch_trainer_loop.py's
  bounds).
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import vipant_tpu.data.packed as jax_packed
from vipant_tpu.config import compose as jax_compose
from vipant_tpu.data import audioset as jax_audioset
from vipant_tpu.data import build_audio_text_dataloader as jax_at_loader
from vipant_tpu.data import build_image_audio_dataloader as jax_va_loader
from vipant_tpu.train import build_monitor as jax_build_monitor
import vipant_tpu_torch.data.packed as packed
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.data import audioset
from vipant_tpu_torch.data import build_audio_text_dataloader, build_image_audio_dataloader
from vipant_tpu_torch.train import build_monitor

from data_synth import (make_synth_audioset, make_synth_clotho, make_synth_va_index,
                        make_synth_va_npz_index)
from fbank_route import pin_numpy_fbank
from test_trainers import TINY_MODEL
from torch_dist_worker import one_rank

NORMS = [-4.9384, 5.7575]
TINY = [*TINY_MODEL, "compute_dtype=float32"]
SHIP = ["running.audio.ship_bf16=True", "running.image_uint8=True"]
LARS = ["optimizer.use_lars=True", "optimizer.warmup_epoch=0", "optimizer.lr_weight=10",
        "optimizer.lr_bias=0.24", "optimizer.eta=0.01"]
RUNNING = {"va": ["+running=bimodal"], "at": ["+running=clotho"],
           "audioset": ["+running=audioset", "running.mixup_rate=0.0"]}


@pytest.fixture(autouse=True, scope="module")
def _numpy_fbank():
    mp = pytest.MonkeyPatch()
    pin_numpy_fbank(mp)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A root each: npz rows (120 frames; 80 frames, shorter than max_len),
    wav rows (1.05 s; 0.6 s, shorter), frame embeddings, Clotho, AudioSet."""
    d = {k: str(tmp_path_factory.mktemp(k))
         for k in ("npz", "npz_short", "wav", "wav_short", "emb", "at", "as")}
    make_synth_va_npz_index(d["npz"], "npz_train", n=8, frames=120)
    make_synth_va_npz_index(d["npz_short"], "npz_train", n=4, frames=80)
    make_synth_va_index(d["wav"], "train", n=8, seconds=1.05)
    make_synth_va_index(d["wav_short"], "train", n=4, seconds=0.6)
    make_synth_va_index(d["emb"], "train", n=4, seconds=1.05)
    os.makedirs(os.path.join(d["emb"], "femb"))
    for i in range(4):
        v = np.random.default_rng(i).standard_normal(32).astype(np.float32)
        np.savez(os.path.join(d["emb"], "femb", f"clip{i}.0.npz"), v=v)
    make_synth_clotho(d["at"], "clotho_dev", n=8, seconds=1.05)
    make_synth_clotho(d["at"], "clotho_val", n=5, seconds=1.05)
    make_synth_audioset(d["as"], "as_train", n=8, seconds=1.05)
    return d


def _over(kind, root, *extra):
    return [*RUNNING[kind], *TINY, f"running.data_root={root}", "running.batch_size=4",
            f"running.audio.norms=[{NORMS[0]}, {NORMS[1]}]", *SHIP, *extra]


def _cfgs(kind, root, *extra):
    over = _over(kind, root, *extra)
    return compose(over), jax_compose(over)


# what each case packs: (kind, root, index, pack_len, overrides)
CASES = {
    "va_npz_above": ("va", "npz", "npz_train", 120, []),
    "va_npz_short_below": ("va", "npz_short", "npz_train", 90, []),
    "va_wav": ("va", "wav", "train", None, []),
    "va_wav_short": ("va", "wav_short", "train", 120, []),
    "va_wav_tile": ("va", "wav_short", "train", 110, ["running.audio.tile_audio=True"]),
    "va_image_emb": ("va", "emb", "train", None, ["running.frame_emb=femb"]),
    "at": ("at", "at", "clotho_dev", 110, []),
    "audioset": ("audioset", "as", "as_train", None, []),
}


def _pack(mod, case, cfg, out):
    kind, _, index, pack_len, _ = CASES[case]
    if kind == "va":
        return mod.pack_image_audio(cfg.running, index, pack_len=pack_len, out_name=out,
                                    image_emb=case == "va_image_emb")
    if kind == "at":
        return mod.pack_audio_text(cfg.running, cfg.model, index, pack_len=pack_len, out_name=out)
    build = audioset.build_audioset_label_map if mod is packed else jax_audioset.build_audioset_label_map
    return mod.pack_audioset(cfg.running, index, build(cfg.running), pack_len=pack_len, out_name=out)


@pytest.fixture(scope="module")
def packs(roots):
    """case -> (root, the JAX package's pack name, the port's)."""
    out = {}
    for case, (kind, root, _, _, extra) in CASES.items():
        port_cfg, jax_cfg = _cfgs(kind, roots[root], *extra)
        jname, pname = f"pak_j_{case}", f"pak_p_{case}"
        _pack(jax_packed, case, jax_cfg, jname)
        _pack(packed, case, port_cfg, pname)
        out[case] = (roots[root], jname, pname)
    return out


# ------------------------------------------------------------------ files
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_packers_write_the_jax_packs_bytes(packs, case):
    root, jname, pname = packs[case]
    jdir, pdir = (os.path.join(root, f"{n}.pak") for n in (jname, pname))
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(pdir))
    want = {"va": {"audio.npy", "image.npy", "lengths.npy"}, "at": {"audio.npy", "text.npy",
            "lengths.npy", "n_caps.npy"}, "audioset": {"audio.npy", "image.npy", "lengths.npy",
            "label.npy"}}[CASES[case][0]] | {"meta.json", "names.json"}
    if case == "va_image_emb":
        want.add("image_emb.npy")
    assert set(files) == want
    for f in files:
        with open(os.path.join(jdir, f), "rb") as a, open(os.path.join(pdir, f), "rb") as b:
            assert a.read() == b.read(), f


def test_the_cases_cover_crops_pads_and_tiling(packs):
    meta = {}
    for case, (root, _, pname) in packs.items():
        d = os.path.join(root, f"{pname}.pak")
        with open(os.path.join(d, "meta.json")) as f:
            meta[case] = (json.load(f), np.load(os.path.join(d, "lengths.npy")))
    assert meta["va_npz_above"][0]["pack_len"] == 120 and (meta["va_npz_above"][1] == 120).all()
    assert meta["va_npz_short_below"][0]["pack_len"] == 90 and (meta["va_npz_short_below"][1] == 80).all()
    assert (meta["va_wav_short"][1] < 100).all()  # padded rows
    assert (meta["va_wav_tile"][1] == 110).all()  # tiled: every row croppable
    assert meta["va_image_emb"][0]["has_image_emb"]


# ---------------------------------------------------------------- batches
def _bits(a):
    """A batch value with the JAX bf16 arrays read as their uint16 bits."""
    if isinstance(a, np.ndarray) and a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _same(got, want, path="batch"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        want = _bits(want)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


def _datasets(kind, root, name, train, *extra):
    port_cfg, jax_cfg = _cfgs(kind, root, *extra)
    if kind == "va":
        return (packed.ImageAudioDatasetPak(port_cfg.running, name, train),
                jax_packed.ImageAudioDatasetPak(jax_cfg.running, name, train))
    if kind == "at":
        np.random.seed(7)  # np_rnd permutes the caption rows with the global RNG
        port = packed.AudioTextDatasetPak(port_cfg.running, name, train)
        np.random.seed(7)
        return port, jax_packed.AudioTextDatasetPak(jax_cfg.running, name, train)
    lm = audioset.build_audioset_label_map(port_cfg.running)
    return (packed.AudiosetDatasetPak(port_cfg.running, name, train, lm),
            jax_packed.AudiosetDatasetPak(jax_cfg.running, name, train,
                                          jax_audioset.build_audioset_label_map(jax_cfg.running)))


BATCH_CASES = ["va_npz_above", "va_npz_short_below", "va_wav_short", "va_image_emb", "at",
               "audioset"]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", BATCH_CASES)
def test_get_batch_is_bitwise_the_jax_batch(packs, case, train, writer):
    kind, _, _, _, extra = CASES[case]
    root, jname, pname = packs[case]
    extra = [*extra, "running.audio.transform_fbank=True"]
    if kind == "at":
        extra.append("running.np_rnd=True")
    port, jds = _datasets(kind, root, jname if writer == "jax" else pname, train, *extra)
    assert bool(port.transform_fbank) == train
    n = len(port)
    for idxs, seed in (([0, 1, 2, 3], 11), ([n - 1, 0, n - 1], 12), (list(range(n)), None)):
        if seed is None:
            np.random.seed(5)
            got = port.get_batch(idxs)
            np.random.seed(5)
            want = jds.get_batch(idxs)
        else:
            got, want = port.get_batch(idxs, seed), jds.get_batch(idxs, seed)
        _same(got, want)
    for i in range(n):  # the items, under one seed of the global RNG
        np.random.seed(100 + i)
        got = port[i]
        np.random.seed(100 + i)
        _same(got, jds[i], f"item {i}")


def test_train_batches_are_cropped_and_masked(packs):
    root, _, pname = packs["va_npz_above"]
    port, _ = _datasets("va", root, pname, True, "running.audio.transform_fbank=True")
    a, b = port.get_batch([0, 0], 1), port.get_batch([0, 0], 2)
    assert a["audio"].dtype == np.uint16 and a["audio"].shape == (2, 1, 100, 128)
    assert not np.array_equal(a["audio"], b["audio"])  # the seed moves the crop and the masks
    assert (a["audio"] == 0).any()  # bf16 +0: the masks' fill


def _loaders(kind, root, name, train, *extra):
    port_cfg, jax_cfg = _cfgs(kind, root, "num_proc=2", *extra)
    if kind == "va":
        return (build_image_audio_dataloader(port_cfg, name, train),
                jax_va_loader(jax_cfg, name, train))
    if kind == "at":
        return (build_audio_text_dataloader(port_cfg, name, train), jax_at_loader(jax_cfg, name, train))
    return (audioset.build_audioset_dataloader(port_cfg, name, train),
            jax_audioset.build_audioset_dataloader(jax_cfg, name, train))


@pytest.mark.parametrize("backend", ["thread", "process"])
@pytest.mark.parametrize("case", ["va_npz_above", "at", "audioset"])
def test_loader_batches_are_the_jax_loaders(packs, case, backend):
    kind = CASES[case][0]
    root, _, pname = packs[case]
    extra = [f"loader_backend={backend}", "running.audio.transform_fbank=True"]
    if kind == "audioset":
        extra += ["running.weighted_sampling=True"]
    port, jl = _loaders(kind, root, pname, True, *extra)
    try:
        for epoch in (0, 1):
            port.set_epoch(epoch)
            jl.set_epoch(epoch)
            got, want = list(port), list(jl)
            assert len(got) == len(want) == 2
            _same(got, want)
        port.set_epoch(1, start_batch=1)  # mid-epoch resume: the tail of epoch 1
        _same(list(port), want[1:])
        ev, jev = _loaders(kind, root, pname, False, f"loader_backend={backend}")
        got, want = list(ev), list(jev)
        _same(got, want)
        assert sum(b["_count"] for b in got) == len(ev.dataset)
        ev.shutdown()
        jev.shutdown()
    finally:
        port.shutdown()
        jl.shutdown()


# ------------------------------------------------------------------ guards
def _raises_alike(port_fn, jax_fn):
    with pytest.raises((ValueError, AssertionError)) as want:
        jax_fn()
    with pytest.raises(want.type) as got:
        port_fn()
    assert str(got.value) == str(want.value)


def _rewrite_meta(root, name, **changes):
    src = os.path.join(root, f"{name}.pak")
    dst = os.path.join(root, f"{name}_bad.pak")
    if os.path.exists(dst):
        import shutil

        shutil.rmtree(dst)
    os.makedirs(dst)
    for f in os.listdir(src):
        if f != "meta.json":
            os.symlink(os.path.join(src, f), os.path.join(dst, f))
    with open(os.path.join(src, "meta.json")) as f:
        meta = json.load(f)
    meta.update(changes)
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(meta, f)
    return f"{name}_bad"


GUARDS = {
    "version": ("va_npz_above", {"version": 99}, []),
    "kind": ("va_npz_above", {"kind": "audio_text"}, []),
    "norms": ("va_npz_above", {}, ["running.audio.norms=[0.0, 1.0]"]),
    "ship_bf16": ("va_npz_above", {}, ["running.audio.ship_bf16=False"]),
    "image_uint8": ("va_npz_above", {}, ["running.image_uint8=False"]),
    "prompt": ("at", {}, ["running.prompt=a photo of"]),
    "mixup": ("audioset", {}, ["running.mixup_rate=0.5"]),
    "label_order": ("audioset", {"label_ids": ["/m/rain", "/m/dog"]}, []),
}


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_guards_raise_as_the_jax_package(packs, guard):
    case, meta, extra = GUARDS[guard]
    kind = CASES[case][0]
    root, _, pname = packs[case]
    name = _rewrite_meta(root, pname, **meta) if meta else pname
    port_cfg, jax_cfg = _cfgs(kind, root, *extra)
    if kind == "va":
        _raises_alike(lambda: packed.ImageAudioDatasetPak(port_cfg.running, name, True),
                      lambda: jax_packed.ImageAudioDatasetPak(jax_cfg.running, name, True))
    elif kind == "at":
        _raises_alike(lambda: packed.AudioTextDatasetPak(port_cfg.running, name, True),
                      lambda: jax_packed.AudioTextDatasetPak(jax_cfg.running, name, True))
    else:
        lm = audioset.build_audioset_label_map(port_cfg.running)
        _raises_alike(lambda: packed.AudiosetDatasetPak(port_cfg.running, name, True, lm),
                      lambda: jax_packed.AudiosetDatasetPak(jax_cfg.running, name, True, lm))


def test_an_image_emb_pack_needs_no_uint8_images(packs):
    root, _, pname = packs["va_image_emb"]
    port, _ = _datasets("va", root, pname, False, "running.frame_emb=femb", "running.image_uint8=False")
    b = port.get_batch([0, 1])
    assert b["image"].dtype == np.float32 and b["image"].shape == (2, 32)


@pytest.mark.parametrize("extra", [["running.clf=False"], ["model.text.ctx_len=40"]],
                         ids=["contrastive_audioset", "at_context"])
def test_loader_guards_raise_as_the_jax_package(packs, extra):
    case = "audioset" if "clf" in extra[0] else "at"
    root, _, pname = packs[case]
    port_cfg, jax_cfg = _cfgs(CASES[case][0], root, *extra)
    if case == "audioset":
        _raises_alike(lambda: audioset.build_audioset_dataloader(port_cfg, pname, True),
                      lambda: jax_audioset.build_audioset_dataloader(jax_cfg, pname, True))
    else:
        _raises_alike(lambda: build_audio_text_dataloader(port_cfg, pname, True),
                      lambda: jax_at_loader(jax_cfg, pname, True))


# ------------------------------------------------------- the AudioSet branch
def test_audioset_filter_then_cap_and_weights_are_the_jax_packages(packs):
    root, _, pname = packs["audioset"]
    with open(os.path.join(root, "keep.csv"), "w") as f:
        f.write("\n".join(["y1", "y2", "y5", "y6", "y7"]) + "\n")
    extra = [f"running.filter_set={os.path.join(root, 'keep.csv')}", "running.eval_samples=3"]
    port_cfg, jax_cfg = _cfgs("audioset", root, *extra)
    jf = jax_audioset.build_filter_set(jax_cfg.running.filter_set, root)
    assert jf, "the filter set must read"
    ev = audioset.build_audioset_dataloader(port_cfg, pname, False)
    jev = jax_audioset.build_audioset_dataloader(jax_cfg, pname, False)
    assert ev.dataset.records == jev.dataset.records == [1, 2, 5]  # filtered, then capped
    port_cfg, jax_cfg = _cfgs("audioset", root, "running.weighted_sampling=True")
    tr = audioset.build_audioset_dataloader(port_cfg, pname, True)
    jtr = jax_audioset.build_audioset_dataloader(jax_cfg, pname, True)
    assert tr.sample_weights.dtype == jtr.sample_weights.dtype
    assert tr.sample_weights.tobytes() == jtr.sample_weights.tobytes() and not tr.shuffle


def test_a_pickled_pack_is_small_and_reopens_its_mmaps(packs):
    for case in ("va_npz_above", "at", "audioset"):
        kind = CASES[case][0]
        root, _, pname = packs[case]
        port, _ = _datasets(kind, root, pname, True)
        blob = pickle.dumps(port)
        assert len(blob) < 1 << 20
        back = pickle.loads(blob)
        for attr in port._ARRAY_ATTRS:
            arr = getattr(back, attr, None)
            if arr is not None:
                assert isinstance(arr, np.memmap), (case, attr)
        _same(back.get_batch([0, 1], 3), port.get_batch([0, 1], 3))


def test_the_cli_packs_all_three_kinds(roots, capsys):
    for kind, root, index, extra in (("va", "npz", "npz_train", ["pack.len=120"]),
                                     ("at", "at", "clotho_val", ["pack.kind=at"]),
                                     ("audioset", "as", "as_train", ["monitor=ASMonitor"])):
        args = [*_over(kind, roots[root], f"running.data_name={index}"), f"pack.out=cli_{kind}",
                "pack.log_every=2", *extra]
        packed.main(args)
        out = capsys.readouterr().out
        d = os.path.join(roots[root], f"cli_{kind}.pak")
        assert out.strip().splitlines()[-1] == d and "packed 2/" in out
        with open(os.path.join(d, "meta.json")) as f:
            assert json.load(f)["kind"] == {"va": "image_audio", "at": "audio_text"}.get(kind, kind)
        jax_packed.main([*args[:-len(extra) - 2], f"pack.out=jcli_{kind}", *extra])
        jd = os.path.join(roots[root], f"jcli_{kind}.pak")
        for f in os.listdir(jd):
            with open(os.path.join(jd, f), "rb") as a, open(os.path.join(d, f), "rb") as b:
                assert a.read() == b.read(), (kind, f)


# ------------------------------------------------------------------ loops
def _loop_over(kind, root, run_dir, *extra):
    task = {
        "va": ["+model/loss=ce", "worker=CVAP", "monitor=VAMonitor", "running.data_name=pak_p_loop",
               "running.eval_name="],
        "at": ["+model/loss=ce", "worker=CLAP", "monitor=LAMonitor", "running.data_name=pak_p_loop",
               "running.eval_name=", "running.test_name="],
        "audioset": ["+model/loss=bce", "worker=ASClassifier", "monitor=ASMonitor",
                     "running.data_name=pak_p_loop", "running.eval_name=", "running.test_name=",
                     "running.weighted_sampling=True", "running.mixup_rate=0.0",
                     "model.audio.freeze=False"],
    }[kind]
    return [*_over(kind, root, *task, *LARS, "running.audio.transform_fbank=True"),
            "running.epochs=2", "running.peep_rate=1", "running.save_rate=1000000",
            "running.save_epoch=False", f"alias_root={run_dir}", f"model_root={run_dir}",
            "model_name=run", "model_file=", "eval=False", "metrics_jsonl=True",
            "loader_backend=thread", "num_proc=1", *extra]


def _losses(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f if line.strip()]


LOOPS = {"va": ("npz", "va_npz_above"), "at": ("at", "at"), "audioset": ("as", "audioset")}


@pytest.mark.parametrize("kind", sorted(LOOPS))
def test_trainer_on_a_pack_matches_the_jax_trainer(roots, packs, tmp_path, kind):
    root_key, case = LOOPS[kind]
    root, _, pname = packs[case]
    loop = os.path.join(root, "pak_p_loop.pak")
    if not os.path.exists(loop):
        os.symlink(os.path.join(root, f"{pname}.pak"), loop)
    jmon = jax_build_monitor(jax_compose(_loop_over(kind, root, str(tmp_path / "jax"))))
    init = jax.tree_util.tree_map(np.asarray, jmon.state.full_params())
    jmon.learn()
    tr = build_monitor(one_rank(_loop_over(kind, root, str(tmp_path / "port"))), device="cpu")
    from_jax.load_params(tr.model, init)
    tr.learn()
    want, got = _losses(jmon.out_dir), _losses(tr.out_dir)
    assert len(got) == len(want) == 4 and len(set(np.round(got, 4))) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = from_jax.model_state_dict(jax.tree_util.tree_map(np.asarray, jmon.state.params))
    assert sorted(final) == sorted(tr.trainable)
    moved = 0.0
    for k, w in final.items():
        got_k = tr.trainable[k].detach().numpy()
        np.testing.assert_allclose(got_k, w, rtol=0, atol=1e-5, err_msg=k)
        moved = max(moved, float(np.abs(w - from_jax.model_state_dict(init)[k]).max()))
    assert moved > 1e-3
    assert isinstance(tr.loader.dataset, packed._PakAudioBase)
    assert torch.is_tensor(tr.model.audio.misc.positional_embedding)
