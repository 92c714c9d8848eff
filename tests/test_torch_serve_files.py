"""The port's serving from files, its HTTP server and its command line
(vipant_tpu_torch/serve.py) against the JAX package's, on the CPU, on the
tiny configs of tests/test_serve.py and tests/test_torch_captioning.py in
fp32, the port's engines carrying the JAX engines' weights
(``ckpt/from_jax``):

- ``fbank_files`` and ``preprocess_images`` (paths and file objects) are
  bitwise the JAX engine's (both host fbanks pointed at their NumPy
  version, ``tests/fbank_route.py``: the C++ one agrees to ~4e-4 only);
  ``embed_audio_files``,
  ``embed_image_files`` and ``export_frame_embeddings`` within 1e-4 of the
  JAX engine's (tests/test_torch_serve.py's fp32 bound), ``caption_files``
  string-equal;
- the server, bound to 127.0.0.1 on a free port, every request with a
  timeout: each route equal to the direct engine calls (within 1e-6:
  JSON carries the fp32 values as doubles), 404 for an unknown route, 400
  for an empty ``wavs_b64``, a missing key, bad JSON and an over-long text,
  the server still up after each and its temp files removed;
- ``python -m vipant_tpu_torch.serve``'s ``main`` with ``platform=cpu``:
  each file task writes what the engine computes; without a card and
  without ``platform=cpu`` it raises, and multi-device serving is refused
  naming A15.
"""

import base64
import glob
import io
import json
import os
import tempfile
import threading
import urllib.error
import urllib.request
from contextlib import contextmanager

import jax
import numpy as np
import pytest

from vipant_tpu.serve import InferenceEngine as JaxEngine
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.serve import InferenceEngine, main, make_server

from data_synth import _tone_wav, make_synth_va_index
from fbank_route import pin_numpy_fbank
from test_torch_captioning import CAPTION_TINY
from test_torch_serve import CVAP, TINY

F32 = ["compute_dtype=float32"]
BATCH = 4
ATOL = 1e-4
TIMEOUT = 60  # seconds, every request


@pytest.fixture(autouse=True, scope="module")
def _numpy_fbank():
    mp = pytest.MonkeyPatch()
    pin_numpy_fbank(mp)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Six wav clips (longer and shorter than the 1.05 s crop) and a VA
    index of five frames (one record with two)."""
    d = tmp_path_factory.mktemp("files")
    wavs = []
    for i, sec in enumerate((1.3, 1.05, 0.6, 1.05, 0.9, 2.0)):
        wavs.append(str(d / f"a{i}.wav"))
        _tone_wav(wavs[-1], sec, freq=300 + 70 * i, seed=i)
    make_synth_va_index(str(d / "va"), "train", n=4, seconds=0.3)
    with open(d / "va" / "train.jsonl") as f:
        recs = [json.loads(line) for line in f]
    recs[0]["frame"] = ["0.jpg", "1.jpg"]
    os.link(d / "va" / "frame" / "clip1.0.jpg", d / "va" / "frame" / "clip0.1.jpg")
    with open(d / "va" / "train.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    jpgs = sorted(glob.glob(str(d / "va" / "frame" / "*.jpg")))
    return {"wavs": wavs, "jpgs": jpgs, "index": str(d / "va" / "train.jsonl"), "dir": d}


def _engines(cfg, towers):
    jeng = JaxEngine(cfg, batch_size=4)
    params = jax.tree_util.tree_map(np.asarray, jeng.variables["params"])
    eng = InferenceEngine(cfg, batch_size=4, device="cpu")
    from_jax.load_params(eng.model, {k: v for k, v in params.items() if k in towers})
    return jeng, eng


@pytest.fixture(scope="module")
def clap():
    return _engines(TINY + F32, ("audio", "text", "loss"))


@pytest.fixture(scope="module")
def cvap():
    return _engines(CVAP + F32, ("image", "audio", "loss"))


@pytest.fixture(scope="module")
def captioner():
    return _engines(CAPTION_TINY + F32 + ["eval=True"], ("audio", "text", "decoder", "loss"))


# ------------------------------------------------------------ file entry points
def test_fbank_files_are_bitwise_the_jax_engines(clap, files):
    jeng, eng = clap
    got, want = eng.fbank_files(files["wavs"]), jeng.fbank_files(files["wavs"])
    assert got.shape == want.shape == (6, 100, 128) and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_embed_audio_files_match_the_jax_engine(clap, files):
    jeng, eng = clap
    got, want = eng.embed_audio_files(files["wavs"]), np.asarray(jeng.embed_audio_files(files["wavs"]))
    assert got.shape == want.shape == (6, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got, eng.embed_audio(eng.fbank_files(files["wavs"])))


@pytest.mark.parametrize("beam", [0, 3])
def test_caption_files_match_the_jax_engine(captioner, files, beam):
    jeng, eng = captioner
    wavs = files["wavs"][:BATCH]  # one batch: the padded last chunk is the other tests'
    got = eng.caption_files(wavs, beam=beam)
    assert len(got) == BATCH and all(isinstance(c, str) for c in got)
    assert got == jeng.caption_files(wavs, beam=beam)


def test_preprocess_and_embed_image_files_match_the_jax_engine(cvap, files):
    jeng, eng = cvap
    jpgs = files["jpgs"]
    got = eng.preprocess_images(jpgs)
    np.testing.assert_array_equal(got, jeng.preprocess_images(jpgs))
    with open(jpgs[0], "rb") as f:
        np.testing.assert_array_equal(eng.preprocess_images([io.BytesIO(f.read())])[0], got[0])
    emb = eng.embed_image_files(jpgs)
    assert emb.shape == (len(jpgs), 32)
    np.testing.assert_allclose(emb, np.asarray(jeng.embed_image_files(jpgs)), atol=ATOL)


def test_export_frame_embeddings_matches_the_jax_engine(cvap, files, tmp_path):
    jeng, eng = cvap
    n = eng.export_frame_embeddings(files["index"], str(tmp_path / "port"))
    assert n == jeng.export_frame_embeddings(files["index"], str(tmp_path / "jax")) == 5
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and "clip0.1.npz" in names
    for name in names:
        got, want = (np.load(tmp_path / side / name)["v"] for side in ("port", "jax"))
        assert got.shape == (32,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL)
    assert eng.export_frame_embeddings(files["index"], str(tmp_path / "port"), frame_key="none") == 0


# ----------------------------------------------------------------- the server
@contextmanager
def _serving(engine):
    srv = make_server(engine, port=0)
    # a short poll: shutdown() waits for the serving loop's next poll
    thread = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(TIMEOUT)


def _post(url, data, ctype="application/json"):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64(path):
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


@pytest.fixture
def own_tmp(tmp_path, monkeypatch):
    """The server's temp files go under their own directory."""
    d = tmp_path / "tmp"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


def test_server_routes_equal_the_engine_calls(clap, files, own_tmp):
    _, eng = clap
    wavs = files["wavs"][:3]
    with _serving(eng) as base:
        assert _get(base + "/health") == (200, {"ok": True})
        code, out = _post(base + "/embed_text", json.dumps({"texts": ["a dog", "rain"],
                                                            "prompt": "the sound of "}).encode())
        assert code == 200
        np.testing.assert_allclose(out["embeddings"], eng.embed_texts(["a dog", "rain"], "the sound of "),
                                   atol=1e-6)
        with open(wavs[0], "rb") as f:
            code, out = _post(base + "/embed_audio", f.read(), ctype="audio/wav")
        assert code == 200
        np.testing.assert_allclose(out["embeddings"], eng.embed_audio_files(wavs[:1]), atol=1e-6)
        code, out = _post(base + "/embed_audio", json.dumps({"wav_b64": _b64(wavs[1])}).encode())
        np.testing.assert_allclose(out["embeddings"], eng.embed_audio_files(wavs[1:2]), atol=1e-6)
        code, out = _post(base + "/embed_audio",
                          json.dumps({"wavs_b64": [_b64(p) for p in wavs]}).encode())
        assert code == 200
        np.testing.assert_allclose(out["embeddings"], eng.embed_audio_files(wavs), atol=1e-6)
        code, out = _post(base + "/zero_shot", json.dumps(
            {"labels": ["dog", "rain", "car"], "wav_b64": _b64(wavs[2])}).encode())
        want = eng.zero_shot(eng.fbank_files(wavs[2:3]), {c: [f"the sound of {c}"]
                                                          for c in ("dog", "rain", "car")})
        assert code == 200 and out["classes"] == want["classes"]
        assert out["prediction"] == want["prediction"]
        np.testing.assert_allclose(out["scores"], want["scores"], atol=1e-6)
    assert os.listdir(own_tmp) == []  # each request's temp wavs removed


@pytest.mark.parametrize("path,body,ctype,code,words", [
    ("/nope", b"{}", "application/json", 404, "no route"),
    ("/embed_audio", json.dumps({"wavs_b64": []}).encode(), "application/json", 400, "empty"),
    ("/embed_audio", json.dumps({"clip": "x"}).encode(), "application/json", 400, "KeyError"),
    ("/embed_text", b"{not json", "application/json", 400, "JSONDecodeError"),
    ("/embed_text", json.dumps({"texts": ["dog " * 200]}).encode(), "application/json", 400, "too long"),
    ("/zero_shot", json.dumps({"labels": ["dog"]}).encode(), "application/json", 400, "KeyError"),
    ("/embed_audio", json.dumps({"wav_b64": ""}).encode(), "application/json", 400, "not a RIFF"),
    ("/caption", None, "audio/wav", 400, "captioning model"),
])
def test_server_status_codes(clap, files, own_tmp, path, body, ctype, code, words):
    """A client's fault is a 400 (``KeyError``, ``ValueError``, bad JSON, the
    tokenizer's "too long"), an unknown route a 404; the server answers the
    next request. (``/caption`` on a model without a decoder: the port's
    engine raises ``ValueError`` before any device work, a 400; the JAX
    engine fails inside its decoder, a 500.)"""
    _, eng = clap
    if body is None:  # a wav clip
        with open(files["wavs"][0], "rb") as f:
            body = f.read()
    with _serving(eng) as base:
        got, out = _post(base + path, body, ctype)
        assert got == code and words in out["error"], out
        assert _get(base + "/health") == (200, {"ok": True})
        assert _get(base + "/nope")[0] == 404
    assert os.listdir(own_tmp) == []


def test_server_serves_captions_and_images(captioner, cvap, files, own_tmp):
    _, cap = captioner
    with _serving(cap) as base:
        for beam, wav in ((0, files["wavs"][0]), (3, files["wavs"][1])):
            code, out = _post(base + f"/caption?beam={beam}", json.dumps({"wavs_b64": [_b64(wav)]}).encode())
            assert code == 200 and out["captions"] == cap.caption_files([wav], beam=beam)
    _, img = cvap
    with _serving(img) as base:
        blobs = [_b64(p) for p in files["jpgs"][:3]]
        code, out = _post(base + "/embed_image", json.dumps({"images_b64": blobs}).encode())
        assert code == 200
        np.testing.assert_allclose(out["embeddings"], img.embed_image_files(files["jpgs"][:3]), atol=1e-6)
        code, out = _post(base + "/embed_image", json.dumps({"image_b64": blobs[0]}).encode())
        np.testing.assert_allclose(out["embeddings"], img.embed_image_files(files["jpgs"][:1]), atol=1e-6)
    assert os.listdir(own_tmp) == []


# ----------------------------------------------------------- the command line
@pytest.mark.parametrize("task", ["embed_audio", "embed_image", "embed_text", "zero_shot", "caption",
                                  "embed_frames"])
def test_cli_writes_what_the_engine_computes(files, tmp_path, capsys, task):
    """``main`` on the CPU (``platform=cpu``); the engine it builds is seeded
    alike, so a direct engine on the same config computes the same."""
    cfg = {"embed_image": CVAP, "embed_frames": CVAP, "caption": CAPTION_TINY}.get(task, TINY) + F32
    out = str(tmp_path / "out.npz")
    clips = str(files["dir"] / ("a[0-1].wav" if task == "caption" else "a[0-3].wav"))  # one batch
    args = {"embed_audio": ["--inputs", clips],
            "embed_image": ["--inputs", str(files["dir"] / "va" / "frame" / "*.jpg")],
            "embed_text": ["--texts", "a dog;heavy rain"],
            "zero_shot": ["--inputs", clips, "--labels", "dog;rain"],
            "caption": ["--inputs", clips, "--beam", "2"],
            "embed_frames": ["--index", files["index"], "--output_dir", str(tmp_path / "frames")]}[task]
    assert main(["--task", task, *args, "--output", out, "--batch_size", str(BATCH), "--",
                 *cfg, "platform=cpu"]) == 0
    eng = InferenceEngine(cfg, batch_size=BATCH, device="cpu")
    wavs = sorted(glob.glob(clips))
    if task == "embed_frames":
        assert len(os.listdir(tmp_path / "frames")) == 5
        assert "wrote 5 frame embeddings" in capsys.readouterr().out
        return
    got = np.load(out)
    if task == "embed_audio":
        np.testing.assert_array_equal(got["embeddings"], eng.embed_audio_files(wavs))
        assert list(got["names"]) == wavs
    elif task == "embed_image":
        np.testing.assert_array_equal(got["embeddings"], eng.embed_image_files(files["jpgs"]))
    elif task == "embed_text":
        np.testing.assert_array_equal(got["embeddings"], eng.embed_texts(["a dog", "heavy rain"]))
    elif task == "zero_shot":
        want = eng.zero_shot(eng.fbank_files(wavs), {c: [f"the sound of {c}"] for c in ("dog", "rain")})
        np.testing.assert_array_equal(got["scores"], want["scores"])
        assert list(got["prediction"]) == want["prediction"]
    else:
        assert list(got["captions"]) == eng.caption_files(wavs, beam=2)
        assert capsys.readouterr().out.count("\t") == len(wavs)


def test_cli_needs_a_card_or_platform_cpu(files, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--task", "embed_text", "--texts", "a dog", "--output", str(tmp_path / "o.npz"), "--",
              *TINY])


@pytest.mark.parametrize("flag,item", [  # ids kept: model-parallel serving is ported (A15-rest)
    pytest.param(["--data_parallel", "--model_parallel", "2"], "pick one", id="flag0-A15-rest"),
    pytest.param(["--model_parallel", "2"], r"must equal the number of ranks \(1\)", id="flag1-A15-rest")])
def test_multi_device_serving_is_refused_by_name(tmp_path, flag, item):
    """``--model_parallel`` with ``--data_parallel`` is refused; without a
    launcher of 2 ranks ``--model_parallel 2`` has no second rank."""
    with pytest.raises(ValueError, match=item):
        main(["--task", "embed_text", "--texts", "a dog", *flag, "--", *TINY, "platform=cpu"])


def test_cli_serves_from_one_process_and_refuses_a_launcher_of_ranks(tmp_path, monkeypatch):
    """Several ranks of the serving CLI would each serve every input: it
    refuses them and points at ``--data_parallel`` (a replica a local card
    in one process)."""
    for k, v in dict(WORLD_SIZE="2", RANK="1", LOCAL_RANK="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="29500").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="--data_parallel"):
        main(["--task", "embed_text", "--texts", "a dog", "--output", str(tmp_path / "o.npz"), "--",
              *TINY, "platform=cpu"])
    assert not (tmp_path / "o.npz").exists()
