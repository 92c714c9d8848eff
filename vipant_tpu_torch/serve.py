"""Batched inference: embeddings, zero-shot classification and captions on
one device, from arrays or from wav and image files, and an HTTP server.

Counterpart of ``vipant_tpu/serve.py``: :class:`InferenceEngine`, its file
entry points, :func:`make_server` and the command line :func:`main`. Every
encoder runs at the fixed ``batch_size`` (the last chunk is padded by
repeating its last row, then trimmed), embeddings come back L2-normalised
as fp32 numpy, and zero-shot takes the max over each class's prompts. The
engine runs on the card (``device="cuda"``, the default; it raises when
there is none), where the transformer sub-blocks run the hand-written
kernels (:mod:`vipant_tpu_torch.ops`); ``device="cpu"`` runs their plain
versions.

The file entry points featurise on the host, as the JAX engine does:
``fbank_files`` (decode, the eval crop, the Kaldi fbank (native, else
NumPy: :func:`..data.transforms_audio.host_fbank`), the configured norms;
:func:`..data.transforms_audio.extract_fbank_features`)
feeds ``embed_audio_files``, ``caption_files`` and the server's audio
routes; ``preprocess_images`` (CLIP's resize, crop and normalisation)
feeds ``embed_image_files`` and ``export_frame_embeddings``, which writes
the per-frame embeddings that ``running.frame_emb`` reads at train time.

``quantize="int8"`` runs every sub-block of every tower on the forward-only
int8 kernels (qkv, out, fc and proj products int8 x int8 -> int32, weights
per output channel, activations per token), scoped to this engine's encode
calls: a bf16 engine beside it is not affected.

The classifiers serve too: ``worker=ESClassifier`` (the audio and text
towers) and ``worker=ASClassifier`` (with the image tower) give
``embed_audio*``, ``embed_texts`` and ``zero_shot`` through their
``encode_audio`` / ``encode_text``, as the JAX engine does. Their
classifier heads need the label count, which the engine does not know: serve
them with ``+model/loss=ce``, as the JAX package's recipe does
(``docs/recipes.md``, "Serving / batch inference").

A CLAP model with a captioning decoder also serves :meth:`caption`:
KV-cached greedy decoding, or beam search, to strings. Under
``quantize="int8"`` the audio tower and the decoder's self-attention and MLP
sub-blocks run int8; the cross-attention has no int8 form and stays bf16.

Weights (:meth:`InferenceEngine._load`): a reference ``.pth``
(``model_file=x.pth``), a step directory's ``model.npz``, CLIP weights
(``running.clip_model_root`` / ``clip_model_name``, e.g. ``ViT-B-32.pt``),
or the seeded random init. Not ported yet: multi-device serving (A15 of
ROADMAP.md's queue A).

Usage::

    from vipant_tpu_torch.serve import InferenceEngine, make_server
    eng = InferenceEngine([...overrides..., "worker=CLAP"], batch_size=64)   # on the card
    a = eng.embed_audio(fbanks)              # [N, D]
    a = eng.embed_audio_files(["x.wav"])     # [N, D]
    t = eng.embed_texts(["a dog barking"])   # [N, D]
    eng8 = InferenceEngine([...], batch_size=64, quantize="int8")
    cap = InferenceEngine([..., "+model/text=transformer_decoder", "+model/loss=ce_lm"])
    strings = cap.caption_files(["x.wav"], beam=4)
    make_server(eng, port=8080).serve_forever()
    esc = InferenceEngine([..., "+running=esc50", "+model/loss=ce", "worker=ESClassifier"])
    esc.zero_shot(esc.fbank_files(["x.wav"]), {"dog": ["the sound of dog"], "rain": ["the sound of rain"]})

Command line (``platform=cpu`` among the overrides runs on the CPU)::

    python -m vipant_tpu_torch.serve --task embed_audio --inputs '*.wav' \
        --output embs.npz -- +running=clotho ... worker=CLAP
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .ckpt.from_jax import batch_stats_state_dict, load_params, read_npz
from .ckpt.loading import apply_reference_ckpt, clip_weights_path, model_towers, report_sources
from .ckpt.reference_port import load_torch_file
from .config import Config
from .models import build_main_model, init_weights, port_model_from_clip
from .nn.heads import normalize
from .ops.quant import int8_fwd_context
from .train.checkpoint import wait_for_saves
from .utils import as_config, require_device, run_root

# the ROADMAP.md queue-A item that ports multi-device serving
_MULTI_DEVICE = "A15"


class InferenceEngine:
    """Config-to-embeddings engine on one device.

    ``cfg``: a composed :class:`vipant_tpu_torch.config.Config` or a list of
    override strings. ``device`` defaults to the card. ``quantize`` is ``""``
    or ``"int8"``. ``token_pack`` packs k items per
    attention call in the image and text towers (exact; applied only when
    it divides ``batch_size``). Weights come from ``model_file`` (a
    reference ``.pth``, or a step directory under ``model_root/model_name``),
    CLIP weights, or a random init seeded with ``seed`` (:meth:`_load`).
    """

    def __init__(
        self,
        cfg,
        batch_size: int = 64,
        device: Union[str, torch.device] = "cuda",
        token_pack: int = 4,
        seed: int = 0,
        quantize: str = "",
        data_parallel: bool = False,
        model_parallel: int = 1,
        echo: Optional[logging.Logger] = None,
    ):
        if quantize not in ("", "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (only 'int8')")
        self._int8 = bool(quantize)
        if data_parallel:
            raise NotImplementedError(
                f"data-parallel serving is not ported yet (ROADMAP.md queue A, {_MULTI_DEVICE})")
        if model_parallel != 1:
            raise NotImplementedError(
                f"model-parallel serving is not ported yet (ROADMAP.md queue A, {_MULTI_DEVICE})")
        self.echo = echo or logging.getLogger(__name__)
        self.cfg = as_config(cfg)
        self.device = require_device(device, "InferenceEngine")
        self.batch_size = int(batch_size)
        if token_pack > 1 and self.batch_size % token_pack == 0:
            # patch a copy: the caller's config may build something else later
            patched, changed = Config(self.cfg.to_dict(resolve=False)), False
            for key in ("image", "text"):
                head = patched.get("model", Config({})).get(key)
                if (
                    head is not None
                    and str(head.get("encoder", Config({})).get("name", "")) == "TransformerBackbone"
                    and head.get("token_pack", None) is None
                ):
                    head["token_pack"] = int(token_pack)
                    changed = True
            if changed:
                self.cfg = patched
        self.model = build_main_model(self.cfg, device=self.device)
        init_weights(self.model, torch.Generator(device=self.device).manual_seed(seed))
        self._load()
        self.model.eval()

    # ------------------------------------------------------------- loading
    def _load(self) -> None:
        """The weights, by the JAX engine's priority
        (``vipant_tpu/serve.py:238-361``): a reference ``.pth``
        ``model_file``; a step directory's ``model.npz``, the towers it
        leaves out from CLIP weights (``running.clip_model_root`` /
        ``clip_model_name``), else from the port trainer's ``state.pt``
        there; no ``model_file``: CLIP weights when they resolve, else the
        seeded random init. Each tower's source is logged."""
        cfg = self.cfg
        model_file = str(cfg.get("model_file", "") or "")
        ckpt_path = os.path.join(
            run_root(cfg.get("model_root", "") or ""), str(cfg.get("model_name", "") or ""), model_file
        )
        if model_file.endswith(".pth"):
            path = next((p for p in (ckpt_path, model_file) if os.path.exists(p)), None)
            if path is None:
                # random weights give plausible unit-norm embeddings: fail loudly
                raise FileNotFoundError(
                    f"model_file {model_file!r} not found at {ckpt_path!r} or as a direct path")
            loaded = apply_reference_ckpt(self.model, path, echo=self.echo)
            report_sources(self.echo, self.model, {t: f"reference checkpoint {path}" for t in loaded})
            return
        if not model_file:
            clip_path = clip_weights_path(cfg)
            if clip_path is None:
                report_sources(self.echo, self.model, {})
                return
            loaded = port_model_from_clip(self.model, load_torch_file(clip_path)[1])
            report_sources(self.echo, self.model, {t: f"CLIP weights {clip_path}" for t in loaded})
            return
        wait_for_saves()  # a step directory this process is still writing
        npz = os.path.join(ckpt_path, "model.npz")
        if not os.path.exists(npz):
            # random weights give plausible unit-norm embeddings: fail loudly
            raise FileNotFoundError(f"model_file {model_file!r}: no model.npz at {npz}")
        params = read_npz(npz)
        towers = model_towers(self.model)
        sources = {t: f"weight export {npz}" for t in towers if t in params}
        uncovered = [t for t in towers if t not in params]
        if uncovered:
            clip_path = clip_weights_path(cfg)
            if clip_path is not None:
                # the whole model from CLIP, then the export over the towers it covers
                loaded = port_model_from_clip(self.model, load_torch_file(clip_path)[1])
                sources.update({t: f"CLIP weights {clip_path}" for t in uncovered if t in loaded})
                uncovered = [t for t in uncovered if t not in loaded]
        if uncovered:
            self._load_from_train_state(ckpt_path, npz, sorted(params), uncovered)
            sources.update({t: f"train state {ckpt_path}/state.pt" for t in uncovered})
        load_params(self.model, params)
        stats = os.path.join(ckpt_path, "batch_stats.npz")
        if os.path.exists(stats):  # the exported towers' BatchNorm statistics (ResNet)
            self._load_buffers(
                {k: torch.from_numpy(v) for k, v in
                 batch_stats_state_dict(read_npz(stats)).items()}, [t for t in towers if t in params])
        report_sources(self.echo, self.model, sources)

    def _load_buffers(self, saved: Dict[str, torch.Tensor], towers: List[str]) -> None:
        """The running statistics of ``towers`` from ``saved`` (buffer name
        -> tensor); every buffer of those towers must be there."""
        own = {k: b for k, b in self.model.named_buffers() if k.split(".", 1)[0] in towers}
        missing = sorted(set(own) - set(saved))
        if missing:
            raise ValueError(f"the checkpoint holds no running statistics for {missing}")
        with torch.no_grad():
            for k, b in own.items():
                b.copy_(saved[k])

    def _load_from_train_state(self, ckpt_path: str, npz: str, covered: List[str],
                               towers: List[str]) -> None:
        """Towers that neither a weight export nor CLIP weights give (the
        VA trainer exports the audio tower and the loss head) come from the
        port trainer's ``state.pt`` in the same step directory, which holds
        every tower as it trained: the frozen ones too."""
        state = os.path.join(ckpt_path, "state.pt")
        if not os.path.exists(state):
            raise ValueError(
                f"{npz} covers only {covered} but the model has tower(s) {towers}, no CLIP "
                f"weights resolve from running.clip_model_root / clip_model_name, and "
                f"{ckpt_path} holds no state.pt; serving them at random init would give "
                "plausible-looking garbage")
        sd = torch.load(state, map_location="cpu", weights_only=True)
        saved = {**sd["frozen_params"], **sd["params"]}
        take = {k: v for k, v in saved.items() if k.split(".", 1)[0] in towers}
        want = {k for k, _ in self.model.named_parameters() if k.split(".", 1)[0] in towers}
        if set(take) != want:
            raise ValueError(f"{state} and the model disagree on {sorted(set(take) ^ want)}")
        self.model.load_state_dict(take, strict=False)
        self._load_buffers(sd.get("buffers", {}), towers)

    # --------------------------------------------------------------- encode
    def _embed_dim(self) -> int:
        """The shared embedding width: the loss head's, else any tower's."""
        model = self.cfg.model
        for group in ("loss", "image", "audio", "text"):
            node = model.get(group, None)
            d = node.get("embed_dim", None) if node is not None else None
            if d:
                return int(d)
        raise ValueError("no embed_dim found in model config")

    def _run_batched(self, method: str, arr: np.ndarray) -> np.ndarray:
        """[N, ...] host array -> fixed [batch_size, ...] device batches ->
        [N, D] fp32, normalised twice (tower, then here, clip 1e-8)."""
        if arr.shape[0] == 0:
            return np.zeros((0, self._embed_dim()), np.float32)
        fn = getattr(self.model, method)
        B = self.batch_size
        outs = []
        with torch.inference_mode(), int8_fwd_context(self._int8):
            for i in range(0, arr.shape[0], B):
                chunk = arr[i : i + B]
                n = chunk.shape[0]
                if n < B:  # pad to the fixed batch by repeating the last row
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], B - n, axis=0)])
                out = normalize(fn(torch.from_numpy(chunk).to(self.device), train=False))
                outs.append(out.float().cpu().numpy()[:n])
        return np.concatenate(outs, axis=0)

    def embed_audio(self, fbanks: np.ndarray) -> np.ndarray:
        """[N, T, M] or [N, 1, T, M] log-mel -> [N, D] normalised."""
        a = np.ascontiguousarray(fbanks, np.float32)
        if a.ndim == 3:
            a = a[:, None]
        return self._run_batched("encode_audio", a)

    def fbank_files(self, paths: Sequence[str]) -> np.ndarray:
        """wav files -> [N, T, M] log-mel (the host frontend, the eval crop,
        the configured norms)."""
        from .data.image_audio import fbank_params_from_cfg
        from .data.transforms_audio import extract_fbank_features

        acfg = self.cfg.running.audio
        params = fbank_params_from_cfg(acfg)
        return np.stack([
            extract_fbank_features(
                p, params, max_audio_len=int(self.cfg.running.max_audio_len), train=False,
                zero_mean_wf=bool(acfg.get("zero_mean_wf", True)),
                norms=tuple(acfg.get("norms", []) or []) or None)
            for p in paths
        ])

    def embed_audio_files(self, paths: Sequence[str]) -> np.ndarray:
        """wav files -> :meth:`fbank_files` -> [N, D] normalised."""
        return self.embed_audio(self.fbank_files(paths))

    def embed_texts(self, texts: Sequence[str], prompt: str = "") -> np.ndarray:
        """Strings -> BPE ids (fixed ctx padding) -> [N, D] normalised."""
        from .tokenizer import tokenize

        ctx = int(self.cfg.model.text.get("ctx_len", 77))
        ids = tokenize([f"{prompt}{t}" for t in texts], context_length=ctx)
        return self._run_batched("encode_text", ids.astype(np.int64))

    def embed_images(self, images: np.ndarray) -> np.ndarray:
        """[N, 3, H, W] CLIP-preprocessed images -> [N, D] normalised."""
        return self._run_batched("encode_image", np.ascontiguousarray(images, np.float32))

    def preprocess_images(self, sources: Sequence[Any]) -> np.ndarray:
        """PIL-openable sources (paths or file-like) -> CLIP preprocessing
        (bicubic resize, center crop, normalise) -> [N, 3, R, R] fp32, on the
        host (the server runs it outside its device lock)."""
        from PIL import Image

        from .data.transforms_image import clip_preprocess

        res = int(self.cfg.running.get("resolution", 224))
        return np.stack([clip_preprocess(Image.open(p), res) for p in sources])

    def embed_image_files(self, paths: Sequence[str]) -> np.ndarray:
        """Image files -> [N, D] normalised."""
        return self.embed_images(self.preprocess_images(paths))

    def export_frame_embeddings(self, index_path: str, out_dir: str, frame_key: str = "frame") -> int:
        """Each frame's image embedding for a VA index, written to
        ``{out_dir}/{id}.{stem}.npz`` (key ``"v"``, [D] fp32): the files that
        ``running.frame_emb`` reads at train time
        (`reference/cvap/data/image_audio.py:209-219` read them; the reference
        shipped no writer). Frames are embedded in chunks, each written before
        the next is read. Returns the number of files written."""
        from .data.indexfile import load_jsonl

        data_root = os.path.dirname(os.path.abspath(index_path))
        os.makedirs(out_dir, exist_ok=True)
        paths, outs = [], []
        for rec in load_jsonl(index_path):
            frames = rec.get(frame_key)
            if frames is None:
                continue
            sub = str(rec.get("dir", "") or "")
            if sub and not sub.endswith("/"):
                sub += "/"
            for ext in [frames] if isinstance(frames, str) else frames:
                paths.append(f"{data_root}/{sub}{frame_key}/{rec['id']}.{ext}")
                outs.append(os.path.join(out_dir, f"{rec['id']}.{ext.rsplit('.', 1)[0]}.npz"))
        chunk = max(self.batch_size * 4, 64)
        for i in range(0, len(paths), chunk):
            for o, v in zip(outs[i:i + chunk], self.embed_image_files(paths[i:i + chunk])):
                np.savez(o, v=np.asarray(v, np.float32))
        self.echo.info(f"wrote {len(outs)} frame embeddings to {out_dir}")
        return len(outs)

    # ------------------------------------------------------------ captioning
    def caption(self, fbanks: np.ndarray, beam: int = 0) -> List[str]:
        """[N, T, M] or [N, 1, T, M] log-mel -> N caption strings: KV-cached
        greedy decoding, or beam search with ``beam`` > 1. Needs a captioning
        model (CLAP with a SeqGenerationHead decoder)."""
        from .tokenizer import detokenize_ids

        if getattr(self.model, "decoder", None) is None:
            raise ValueError("caption needs a captioning model: CLAP with "
                             "model.text.name=SeqGenerationHead")
        a = np.ascontiguousarray(fbanks, np.float32)
        if a.ndim == 3:
            a = a[:, None]
        B = self.batch_size
        out: List[str] = []
        with torch.inference_mode(), int8_fwd_context(self._int8):
            for i in range(0, a.shape[0], B):
                chunk = a[i : i + B]
                n = chunk.shape[0]
                if n < B:  # pad to the fixed batch by repeating the last row
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], B - n, axis=0)])
                ids, _ = self.model.decode(torch.from_numpy(chunk).to(self.device), beam=int(beam))
                out.extend(detokenize_ids(row) for row in ids.cpu().numpy()[:n])
        return out

    def caption_files(self, paths: Sequence[str], beam: int = 0) -> List[str]:
        """wav files -> :meth:`fbank_files` -> caption strings."""
        return self.caption(self.fbank_files(paths), beam=beam)

    # ------------------------------------------------------------ zero-shot
    def zero_shot(
        self,
        fbanks: np.ndarray,
        class_prompts: Dict[str, Sequence[str]],
        temperature: float = 100.0,
    ) -> Dict[str, Any]:
        """Multi-prompt zero-shot: prompts are scored and collapsed per class
        by their max; probabilities are softmax(temperature * score)."""
        classes = list(class_prompts)
        flat, owner = [], []
        for ci, c in enumerate(classes):
            if not class_prompts[c]:
                raise ValueError(f"class {c!r} has no prompts")
            flat.extend(class_prompts[c])
            owner.extend([ci] * len(class_prompts[c]))
        t = self.embed_texts(flat)
        a = self.embed_audio(fbanks)
        sims = a @ t.T  # [N, P]
        owner_arr = np.asarray(owner)
        per_class = np.stack(
            [sims[:, owner_arr == ci].max(axis=1) for ci in range(len(classes))], axis=1
        )
        return {
            "classes": classes,
            "scores": per_class,
            "probs": _softmax(per_class * temperature),
            "prediction": [classes[i] for i in per_class.argmax(axis=1)],
        }


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# the HTTP server and the command line
# ---------------------------------------------------------------------------


def make_server(engine: InferenceEngine, port: int = 8080, host: str = "127.0.0.1"):
    """A stdlib HTTP endpoint over ``engine`` (counterpart of
    ``vipant_tpu/serve.py:make_server``). Routes, JSON out:

    - ``GET /health`` -> ``{"ok": true}``
    - ``POST /embed_text`` ``{"texts": [...], "prompt": ""}`` -> ``{"embeddings": [[...]]}``
    - ``POST /embed_audio``: a raw WAV body, or JSON ``{"wav_b64": ...}`` or
      ``{"wavs_b64": [...]}`` -> ``{"embeddings": [[...]]}``
    - ``POST /embed_image`` ``{"images_b64": [...]}`` (or ``image_b64``) ->
      ``{"embeddings": [[...]]}``
    - ``POST /caption?beam=N``: audio as for ``/embed_audio`` -> ``{"captions": [...]}``
    - ``POST /zero_shot`` ``{"labels": [...], "prompt": "the sound of ", "wav_b64": ...}``
      -> ``{"classes", "scores", "prediction"}``

    Errors are ``{"error": ...}``: 400 for a client's fault (``KeyError``,
    ``ValueError``, bad JSON, the tokenizer's "too long"), 404 for an
    unknown route, 500 otherwise; the server stays up. Decoding and the
    host featurisation run outside the lock that serialises the device
    calls; the temp files of a request are removed after it. Returns the
    ``ThreadingHTTPServer`` (``serve_forever()`` / ``shutdown()``; port 0
    picks a free one, ``server_address`` says which)."""
    import base64
    import io
    import json
    import tempfile
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    lock = threading.Lock()

    def wavs_from_request(body: bytes, ctype: str, payload=None) -> List[str]:
        """The request's clips as temp wav files (the host fbank reads
        files); ``payload``: the JSON body when the route parsed it."""
        if ctype.startswith("application/json"):
            if payload is None:
                payload = json.loads(body)
            if "wavs_b64" in payload:
                blobs = payload["wavs_b64"]
                if not blobs:
                    raise ValueError("wavs_b64 is empty: supply at least one clip")
            else:
                blobs = [payload["wav_b64"]]
            raws = [base64.b64decode(b) for b in blobs]
        else:
            raws = [body]
        paths = []
        for raw in raws:
            with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                f.write(raw)
            paths.append(f.name)
        return paths

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            engine.echo.info("http " + fmt % args)

        def _send(self, code: int, obj) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if urlparse(self.path).path == "/health":
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def _route(self, path: str, query, body: bytes, ctype: str, tmp: List[str]):
            """(status, JSON reply) of one POST; temp files go into ``tmp``."""
            if path == "/embed_text":
                payload = json.loads(body)
                with lock:
                    emb = engine.embed_texts(payload["texts"], prompt=payload.get("prompt", ""))
                return 200, {"embeddings": emb.tolist()}
            if path == "/embed_audio":
                tmp += wavs_from_request(body, ctype)
                fb = engine.fbank_files(tmp)
                with lock:
                    emb = engine.embed_audio(fb)
                return 200, {"embeddings": emb.tolist()}
            if path == "/embed_image":
                payload = json.loads(body)
                blobs = payload.get("images_b64") or [payload["image_b64"]]
                imgs = engine.preprocess_images([io.BytesIO(base64.b64decode(b)) for b in blobs])
                with lock:
                    emb = engine.embed_images(imgs)
                return 200, {"embeddings": emb.tolist()}
            if path == "/caption":
                tmp += wavs_from_request(body, ctype)
                beam = int(query.get("beam", ["0"])[0])
                fb = engine.fbank_files(tmp)
                with lock:
                    caps = engine.caption(fb, beam=beam)
                return 200, {"captions": caps}
            if path == "/zero_shot":
                payload = json.loads(body)
                tmp += wavs_from_request(body, "application/json", payload=payload)
                prompt = payload.get("prompt", "the sound of ")
                fb = engine.fbank_files(tmp)
                with lock:
                    res = engine.zero_shot(fb, {label: [f"{prompt}{label}"] for label in payload["labels"]})
                return 200, {"classes": list(res["classes"]),
                             "scores": np.asarray(res["scores"]).tolist(),
                             "prediction": list(res["prediction"])}
            return 404, {"error": f"no route {path}"}

        def do_POST(self):
            url = urlparse(self.path)
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            tmp: List[str] = []
            try:
                code, reply = self._route(url.path, parse_qs(url.query), body,
                                          self.headers.get("Content-Type", ""), tmp)
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                code, reply = 400, {"error": f"{type(e).__name__}: {e}"}
            except Exception as e:  # noqa: BLE001 - a bad request must not stop the server
                # the tokenizer raises RuntimeError for an over-long text: the client's fault
                code = 400 if isinstance(e, RuntimeError) and "too long" in str(e) else 500
                reply = {"error": f"{type(e).__name__}: {e}"}
            finally:
                for p in tmp:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            self._send(code, reply)

    return ThreadingHTTPServer((host, port), Handler)


TASKS = ("embed_audio", "embed_image", "embed_text", "zero_shot", "caption", "embed_frames", "serve")


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m vipant_tpu_torch.serve --task ... -- <config overrides>``
    (counterpart of ``vipant_tpu/serve.py:main``): on the card, or on the CPU
    with ``platform=cpu`` among the overrides."""
    import argparse
    import glob

    ap = argparse.ArgumentParser(
        description="Batched VIP-ANT inference (embeddings, zero-shot, captions, an HTTP "
        "server). Config overrides follow `--` in hydra-style grammar.")
    ap.add_argument("--task", required=True, choices=TASKS)
    ap.add_argument("--index", default="", help="embed_frames: VA index .jsonl")
    ap.add_argument("--output_dir", default="", help="embed_frames: per-frame npz directory")
    ap.add_argument("--port", type=int, default=8080, help="serve: HTTP port")
    ap.add_argument("--host", default="127.0.0.1", help="serve: bind address")
    ap.add_argument("--beam", type=int, default=0, help="caption: beam width (0 = greedy)")
    ap.add_argument("--inputs", default="", help="wav/image glob (embed_*, zero_shot, caption)")
    ap.add_argument("--texts", default="", help="newline-separated file or inline ';'-list")
    ap.add_argument("--labels", default="", help="zero_shot: ';'-separated class names")
    ap.add_argument("--prompt", default="the sound of ", help="zero_shot prompt prefix")
    ap.add_argument("--output", default="out.npz")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--quantize", default="", choices=["", "int8"],
                    help="int8: every sub-block on the int8 kernels (serving only)")
    ap.add_argument("--data_parallel", action="store_true",
                    help=f"not ported yet (ROADMAP.md queue A, {_MULTI_DEVICE})")
    ap.add_argument("--model_parallel", type=int, default=1,
                    help=f"> 1 is not ported yet (ROADMAP.md queue A, {_MULTI_DEVICE})")
    args, overrides = ap.parse_known_args(argv)
    cfg = as_config([o for o in overrides if o != "--"])
    eng = InferenceEngine(cfg, batch_size=args.batch_size, quantize=args.quantize,
                          data_parallel=args.data_parallel, model_parallel=args.model_parallel,
                          device="cpu" if str(cfg.get("platform") or "") == "cpu" else "cuda")

    def inputs() -> List[str]:
        paths = sorted(glob.glob(args.inputs))
        if not paths:
            raise SystemExit(f"no inputs match {args.inputs!r}")
        return paths

    if args.task in ("embed_audio", "embed_image"):
        paths = inputs()
        embed = eng.embed_audio_files if args.task == "embed_audio" else eng.embed_image_files
        np.savez(args.output, embeddings=embed(paths), names=np.array(paths))
    elif args.task == "caption":
        paths = inputs()
        caps = eng.caption_files(paths, beam=args.beam)
        np.savez(args.output, captions=np.array(caps), names=np.array(paths))
        for p, c in zip(paths, caps):
            print(f"{p}\t{c}")
    elif args.task == "serve":
        srv = make_server(eng, port=args.port, host=args.host)
        print(f"serving on http://{args.host}:{srv.server_address[1]} (ctrl-c to stop)", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
        return 0
    elif args.task == "embed_frames":
        if not (args.index and args.output_dir):
            raise SystemExit("embed_frames needs --index and --output_dir")
        n = eng.export_frame_embeddings(args.index, args.output_dir)
        print(f"wrote {n} frame embeddings to {args.output_dir}")
        return 0
    elif args.task == "embed_text":
        if os.path.exists(args.texts):
            with open(args.texts) as f:
                texts = [line.strip() for line in f if line.strip()]
        else:
            texts = [t for t in args.texts.split(";") if t]
        np.savez(args.output, embeddings=eng.embed_texts(texts), names=np.array(texts))
    else:
        paths, labels = inputs(), [label for label in args.labels.split(";") if label]
        if not labels:
            raise SystemExit("zero_shot needs --labels")
        res = eng.zero_shot(eng.fbank_files(paths), {label: [f"{args.prompt}{label}"] for label in labels})
        np.savez(args.output, scores=res["scores"], names=np.array(paths),
                 classes=np.array(res["classes"]), prediction=np.array(res["prediction"]))
        for p, c in zip(paths, res["prediction"]):
            print(f"{p}\t{c}")
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
