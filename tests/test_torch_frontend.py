"""The port's device frontend against the JAX package's, on the CPU:

- ``ops/fbank.py`` against ``vipant_tpu.ops.fbank`` on both routes (rFFT
  and DFT-as-matmul), batched and unbatched, at 1 s and 10.05 s, and
  against the NumPy Kaldi fbank, at the JAX tests' own bounds
  (``tests/test_fbank.py``: 2e-3 for the rFFT; ``tests/test_on_device_frontend.py``:
  5e-3 for the DFT); ``fbank_fixed_len``'s truncation, zero padding and
  normalisation against the JAX one (2e-3) and exactly in structure;
- SpecAugment: the masks from the uniforms the JAX package draws from a
  key are bitwise its masks;
- the shipping formats: ``_audio_waveform``'s eval items (fp32 and int16,
  a clip longer and one shorter than the crop) and the npz dataset's
  ``ship_int16`` codes bitwise the JAX package's; ``ship_bf16`` bits
  bitwise ``ml_dtypes``' rounding (this file may import it, the port does
  not); ``clip_preprocess_uint8`` bitwise the JAX one;
  ``device_normalize_image`` within one fp32 ulp of the JAX one; collated
  batches of each format bitwise the JAX loader's;
- the refusals: ``on_device`` with ``dither`` or ``use_energy`` raises,
  where the JAX package's device fbank ignores both (its host fbank
  applies the dither).
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from PIL import Image

from vipant_tpu.config import compose as jax_compose
from vipant_tpu.data import build_image_audio_dataloader as jax_build_loader
from vipant_tpu.data import image_audio as jax_image_audio
from vipant_tpu.data import transforms_image as jax_transforms_image
from vipant_tpu.ops import fbank as jax_fbank_fn
from vipant_tpu.ops import specaugment as jax_specaugment
from vipant_tpu.ops.fbank import fbank_fixed_len as jax_fbank_fixed_len
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.data import build_image_audio_dataloader, image_audio, transforms_image
from vipant_tpu_torch.ops import fbank as port_fbank
from vipant_tpu_torch.ops import specaugment
from vipant_tpu_torch.ops.fbank_np import FbankParams
from vipant_tpu_torch.ops.frontend import device_normalize_image
from vipant_tpu_torch.train import Trainer

from data_synth import make_synth_va_index, make_synth_va_npz_index

jax_fbank_np = importlib.import_module("vipant_tpu.ops.fbank_np")
TOL = {"rfft": 2e-3, "dft": 5e-3}  # max |d| of the log-mel, per route
FIXED_TOL = 2e-3

BASE = [
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default", "worker=CVAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "running.audio.max_len=100", "running.batch_size=4",
    "loader_backend=thread", "num_proc=1",
]


def _only_batch(loader):
    """The loader's one batch, its epoch run to the end: a thread loader left
    with items in flight would go on seeding NumPy's global generator."""
    (batch,) = list(loader)
    return batch


def _clips(seconds, n=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return np.stack([(0.4 * np.sin(2 * np.pi * (300 + 580 * i) * t)
                      + 0.01 * rng.standard_normal(len(t))).astype(np.float32) for i in range(n)])


# ------------------------------------------------------------------- fbank
@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("route", ["rfft", "dft"])
@pytest.mark.parametrize("seconds", [1.0, 10.05])
def test_fbank_matches_the_jax_and_the_numpy_fbank(seconds, route, batched):
    wavs = _clips(seconds)
    x = wavs if batched else wavs[0]
    use_dft = route == "dft"
    got = port_fbank.fbank(torch.from_numpy(x), FbankParams(), use_dft=use_dft).numpy()
    want = np.asarray(jax_fbank_fn(x, jax_fbank_np.FbankParams(), use_dft=use_dft))
    host = np.stack([jax_fbank_np.fbank(w) for w in wavs])
    host = host if batched else host[0]
    frames = FbankParams().num_frames(wavs.shape[-1])
    assert got.shape == want.shape == host.shape and got.shape[-2:] == (frames, 128)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < TOL[route], np.abs(got - want).max()
    assert np.abs(got - host).max() < TOL[route], np.abs(got - host).max()


@pytest.mark.parametrize("norms", [None, (-4.93839311, 5.75751113)])
@pytest.mark.parametrize("max_frames", [60, 98, 150])
def test_fbank_fixed_len_matches_the_jax_one(max_frames, norms):
    wavs = _clips(1.0, n=3, seed=1)
    got = port_fbank.fbank_fixed_len(torch.from_numpy(wavs), FbankParams(), max_frames, norms).numpy()
    want = np.asarray(jax_fbank_fixed_len(wavs, jax_fbank_np.FbankParams(), max_frames, norms))
    assert got.shape == want.shape == (3, max_frames, 128)
    assert np.abs(got - want).max() < FIXED_TOL
    full = port_fbank.fbank(torch.from_numpy(wavs), FbankParams()).numpy()
    n = min(max_frames, full.shape[1])
    mean, std = norms or (0.0, 1.0)
    want_head = ((full[:, :n] - np.float32(mean)) / np.float32(std)) if norms else full[:, :n]
    np.testing.assert_array_equal(got[:, :n], want_head)  # truncation keeps the head
    pad = np.float32((0 - np.float32(mean)) / np.float32(std))
    assert (got[:, n:] == pad).all()  # the padding is the normalised zero frame


@pytest.mark.parametrize("bad", [{"dither": 1.0}, {"use_energy": True}, {"snip_edges": False}])
def test_the_device_fbank_refuses_what_it_would_compute_otherwise(bad):
    with pytest.raises(NotImplementedError, match=next(iter(bad))):
        port_fbank.fbank(torch.zeros(2, 1600), FbankParams(**bad))


@pytest.mark.parametrize("extra", [["running.audio.dither=1.0"], ["running.audio.use_energy=True"]])
def test_on_device_with_dither_or_energy_is_refused(tmp_path, extra):
    """The JAX package's device fbank ignores both (its host fbank applies
    the dither): the port refuses, in the data layer and in the trainer."""
    key = extra[0].split(".")[-1].split("=")[0]
    make_synth_va_index(str(tmp_path), "train", n=4, seconds=1.05)
    over = BASE + [f"running.data_root={tmp_path}", "running.audio.on_device=True", *extra]
    with pytest.raises(NotImplementedError, match=key):
        build_image_audio_dataloader(compose(over), "train", True)
    with pytest.raises(NotImplementedError, match=key):
        Trainer(over + ["model_file="], device="cpu")
    # without on_device both stay with the host fbank, as in the JAX package
    build_image_audio_dataloader(compose([o for o in over if o != "running.audio.on_device=True"]),
                                 "train", True)


# ------------------------------------------------------------- SpecAugment
def _jax_uniforms(key, batch):
    """The uniforms in [0, 1) behind ``vipant_tpu.ops.specaugment._axis_mask(key, ...)``."""
    k1, k2 = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.uniform(k, (batch, 1)))) for k in (k1, k2))


@pytest.mark.parametrize("seed,freq_p,time_p", [(0, 32, 200), (1, 48, 300), (2, 7, 13)])
def test_spec_augment_masks_are_bitwise_the_jax_ones(seed, freq_p, time_p):
    feats = np.random.default_rng(seed).standard_normal((6, 100, 128)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    kf, kt = jax.random.split(key)
    want = np.asarray(jax_specaugment.spec_augment(key, jnp.asarray(feats), freq_p, time_p))
    got = specaugment.freq_mask(torch.from_numpy(feats), freq_p, _jax_uniforms(kf, 6))
    got = specaugment.time_mask(got, time_p, _jax_uniforms(kt, 6)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and not (got == 0).all()
    for ax, k, p in ((2, kf, freq_p), (1, kt, time_p)):
        mask = np.asarray(jax_specaugment._axis_mask(k, 6, feats.shape[ax], p))
        np.testing.assert_array_equal(
            specaugment._axis_mask(*_jax_uniforms(k, 6), feats.shape[ax], p).numpy(), mask)


def test_spec_augment_draws_from_its_generator():
    feats = torch.randn(4, 100, 128, generator=torch.Generator().manual_seed(0))
    out = [specaugment.spec_augment(feats, torch.Generator().manual_seed(s), 32, 50) for s in (3, 3, 4)]
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
    g = torch.Generator().manual_seed(3)
    assert not torch.equal(specaugment.spec_augment(feats, g, 32, 50),
                           specaugment.spec_augment(feats, g, 32, 50))  # each call draws anew
    assert torch.equal(specaugment.spec_augment(feats, g, 0, 0), feats)
    masked = (out[0] != feats)
    assert masked.any(dim=(1, 2)).all()  # every item got its own bands


# ------------------------------------------------------------------ shipping
def _datasets(root, *extra, name="train", npz=False):
    over = BASE + [f"running.data_root={root}", *extra]
    cls = "ImageAudioDatasetNpz" if npz else "ImageAudioDatasetSrc"
    return (getattr(jax_image_audio, cls)(jax_compose(over).running, name, False),
            getattr(image_audio, cls)(compose(over).running, name, False))


@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("seconds", [1.1, 0.6])
def test_audio_waveform_items_are_bitwise_the_jax_ones(tmp_path, seconds, int16):
    """The eval crop of 1.05 s: a 1.1 s clip is cropped, a 0.6 s clip
    zero-meaned over its true length, then padded."""
    make_synth_va_index(str(tmp_path), "train", n=3, seconds=seconds)
    jds, ds = _datasets(tmp_path, "running.audio.on_device=True",
                        f"running.audio.wav_int16={int16}")
    for i in range(3):
        want, item = jds[i]["audio"], ds[i]
        got = item["audio"]
        assert got.dtype == want.dtype == (np.int16 if int16 else np.float32)
        assert got.shape == (16800,) and item["audio_len"] == min(int(seconds * 16000), 16800)
        np.testing.assert_array_equal(got, want)
    if seconds < 1.05:
        assert (got[int(seconds * 16000):] == 0).all()


@pytest.mark.parametrize("fmt", ["ship_int16", "ship_bf16"])
def test_npz_shipping_formats_are_bitwise_the_jax_ones(tmp_path, fmt):
    make_synth_va_npz_index(str(tmp_path), "npz_train", n=3, frames=120)
    jds, ds = _datasets(tmp_path, f"running.audio.{fmt}=True", "running.audio.norms=[-4.9,5.7]",
                        name="npz_train", npz=True)
    for i in range(3):
        want, got = jds[i]["audio"], ds[i]["audio"]
        if fmt == "ship_bf16":
            assert want.dtype == ml_dtypes.bfloat16 and got.dtype == np.uint16
            want = want.view(np.uint16)
        else:
            assert got.dtype == want.dtype == np.int16
        assert got.shape == (100, 128)
        np.testing.assert_array_equal(got, want)


def test_bf16_bits_are_ml_dtypes_rounding():
    r = np.random.default_rng(0)
    with np.errstate(over="ignore"):
        x = (r.standard_normal(200000).astype(np.float32)
             * np.float32(10.0) ** r.integers(-40, 39, 200000).astype(np.float32))
    raw = r.integers(0, 2 ** 32, 200000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    edge = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1 + 2 ** -8, 1 + 3 * 2 ** -8,
                     3.3895314e38, 1e-45, -1e-40], np.float32)
    x = np.concatenate([x, raw, edge])
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(image_audio.bf16_bits(x), want)


@pytest.mark.parametrize("size,shape", [(64, (96, 80)), (224, (61, 300)), (32, (32, 32))])
def test_clip_preprocess_uint8_is_bitwise_the_jax_one(size, shape):
    arr = (np.random.default_rng(size).random((*shape, 3)) * 255).astype(np.uint8)
    img = Image.fromarray(arr)
    got = transforms_image.clip_preprocess_uint8(img, size)
    assert got.dtype == np.uint8 and got.shape == (3, size, size) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, jax_transforms_image.clip_preprocess_uint8(img, size))


def test_device_normalize_image_is_within_an_ulp_of_the_jax_one():
    """One fp32 ulp of the JAX package's value, and the float path's
    ``clip_preprocess`` within 1e-5 (the JAX test's bound)."""
    x = np.random.default_rng(0).integers(0, 256, (4, 3, 32, 32)).astype(np.uint8)
    x[0, :, 0, :2] = [[0, 255]] * 3
    want = np.asarray(jax_transforms_image.device_normalize_image(jnp.asarray(x)))
    got = device_normalize_image(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    img = Image.fromarray((np.random.default_rng(1).random((40, 50, 3)) * 255).astype(np.uint8))
    u8 = transforms_image.clip_preprocess_uint8(img, 32)
    ref = transforms_image.clip_preprocess(img, 32)
    assert np.abs(device_normalize_image(torch.from_numpy(u8[None])).numpy()[0] - ref).max() < 1e-5


@pytest.mark.parametrize("extra,name,dtypes", [
    (["running.audio.on_device=True"], "train", (np.float32, np.float32)),
    (["running.audio.on_device=True", "running.audio.wav_int16=True", "running.image_uint8=True"],
     "train", (np.uint8, np.int16)),
    (["running.audio.ship_int16=True"], "npz_train", (np.float32, np.int16)),
    (["running.audio.ship_bf16=True", "running.image_uint8=True"], "npz_train", (np.uint8, np.uint16)),
])
def test_collated_batches_keep_the_ship_dtypes(tmp_path, extra, name, dtypes):
    """A waveform batch stays [B, N], a fbank batch becomes [B, 1, T, M]:
    bitwise the JAX loader's (bf16 as its bits) on the thread backend."""
    make_synth_va_index(str(tmp_path), "train", n=4, seconds=0.6)
    make_synth_va_npz_index(str(tmp_path), "npz_train", n=4, frames=120)
    over = BASE + [f"running.data_root={tmp_path}", *extra]
    got = _only_batch(build_image_audio_dataloader(compose(over), name, False))
    want = _only_batch(jax_build_loader(jax_compose(over), name, False))
    for key, dtype in zip(("image", "audio"), dtypes):
        w = want[key]
        if w.dtype == ml_dtypes.bfloat16:
            w = w.view(np.uint16)
        assert got[key].dtype == w.dtype == dtype, key
        np.testing.assert_array_equal(got[key], w)
    assert got["audio"].shape == ((4, 16800) if name == "train" else (4, 1, 100, 128))
    if name == "train":  # the waveforms' true lengths ride along
        np.testing.assert_array_equal(got["audio_len"], [9600] * 4)
    else:
        assert "audio_len" not in got


@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("seconds", [0.6, 1.05])
def test_the_frontend_pads_a_short_clip_as_the_host_does(tmp_path, seconds, int16):
    """A fault of the JAX package's device frontend, repaired in the port:
    it computes the fbank of the zero-padded waveform, so the frames past a
    clip shorter than the crop are log(eps) (normalised) where the host
    path pads the fbank with zeros, and the frames across the clip's end
    mix in the padding. The port zeroes the frames past each clip's true
    length (``audio_len``): its features are the host path's, within the
    fbank tolerance (int16: 0.2 at most, 5e-3 on average, the JAX test's
    bound for the quantisation noise); at the full crop all three agree."""
    make_synth_va_index(str(tmp_path), "train", n=2, seconds=seconds)
    extra = ["running.audio.norms=[-4.93839311,5.75751113]"]
    over = BASE + [f"running.data_root={tmp_path}", "running.audio.transform_fbank=False", *extra]
    host = _only_batch(build_image_audio_dataloader(compose(over), "train", False))["audio"][:, 0]
    ship = over + ["running.audio.on_device=True", f"running.audio.wav_int16={int16}"]
    batch = _only_batch(build_image_audio_dataloader(compose(ship), "train", False))
    tr = Trainer(ship + ["model_file="], device="cpu", steps_per_epoch=1)
    got = tr.eval_frontend_args(batch)[1][:, 0].numpy()
    jbatch = _only_batch(jax_build_loader(jax_compose(ship), "train", False))
    wav = jbatch["audio"].astype(np.float32)
    if int16:  # the JAX trainer's own rescale (trainer.py:556-565)
        wav = wav * np.float32(1.0 / 32767.0)
        wav = wav - wav.mean(axis=-1, keepdims=True)
    jax_dev = np.asarray(jax_fbank_fixed_len(wav, jax_fbank_np.FbankParams(), 100,
                                             norms=(-4.93839311, 5.75751113)))
    d = np.abs(got - host)
    if int16:
        assert d.max() < 0.2 and d.mean() < 5e-3, (d.max(), d.mean())
    else:
        assert d.max() < FIXED_TOL, d.max()
    past = FbankParams().num_frames(int(seconds * 16000))
    if past < 100:
        assert (got[:, past:] == host[:, past:]).all()  # the normalised zero frame
        # the JAX package's: a frame all in the padding is log(eps), normalised
        assert np.abs(jax_dev[:, -1] - host[:, -1]).min() > 1.0
    else:
        assert np.abs(jax_dev - got).max() < FIXED_TOL


def test_on_device_tiles_a_short_clip_as_the_host_does(tmp_path):
    """``running.audio.tile_audio``: the host path repeats a short clip to
    the crop's 10 s before the crop; the JAX package's waveform item
    ignores it (zero padding), the port's tiles as the host does."""
    make_synth_va_index(str(tmp_path), "train", n=2, seconds=0.3)
    over = BASE + [f"running.data_root={tmp_path}", "running.audio.transform_fbank=False",
                   "running.audio.tile_audio=True"]
    host = _only_batch(build_image_audio_dataloader(compose(over), "train", False))["audio"][:, 0]
    ship = over + ["running.audio.on_device=True"]
    batch = _only_batch(build_image_audio_dataloader(compose(ship), "train", False))
    np.testing.assert_array_equal(batch["audio_len"], [16000] * 4)  # the eval batch padded to 4
    got = Trainer(ship + ["model_file="], device="cpu", steps_per_epoch=1).eval_frontend_args(batch)[1]
    assert np.abs(got[:, 0].numpy() - host).max() < FIXED_TOL
    jax_wav = _only_batch(jax_build_loader(jax_compose(ship), "train", False))["audio"]
    assert (jax_wav[:, 4800:] == 0).all()  # not tiled
