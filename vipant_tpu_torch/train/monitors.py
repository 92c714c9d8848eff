"""The monitors beyond VA pre-training on one device: ``LAMonitor``
(audio-text fine-tuning, retrieval and captioning; image-text CLVP with
``running.dataloader=lv``), ``VALMonitor`` (trimodal V-A-L on AudioSet),
``VASMonitor`` (multi-view siamese VA), ``ASMonitor`` (AudioSet
multi-label classification and zero-shot) and ``ESCMonitor`` (ESC-50 / US8K
x-fold classification and zero-shot; :class:`ESCTrainer`).

Counterpart of ``vipant_tpu/train/monitors.py:33-257`` (``LATrainer``;
parity: `reference/cvap/monitor/clap.py`). :class:`LATrainer` trains CLAP
from a Clotho CSV or AudioCaps JSONL index (:mod:`..data.audio_text`):
``(fbank, token ids)`` batches put on the card through pinned memory, the
contrastive loss over the audio and text towers (the text tower frozen by
``model.text.freeze``), or the captioning loss of the
``SeqGenerationHead`` decoder (:meth:`.trainer.Trainer.build_model`'s
``loss_kwargs``). Its save-time eval is the 1-vs-k retrieval report, or for
a captioning model the caption report, and is skipped while the
contrastive CE is at or above ``running.eval_loss_bound`` (default 5; inf
never skips); a ``TEST`` pass over ``running.test_name`` follows training.
``model_file=<log>.out`` evaluates every step directory that log names
(:meth:`LATrainer.repeated_retrieval`); :meth:`LATrainer.encode_text` writes
each clip's caption embeddings.

The AT recipe starts from a VA checkpoint: ``model_file=<step>.pth`` (a
reference ``.pth``, e.g. one a VA run wrote with ``export_pth``) loads its
audio tower (:meth:`.trainer.Trainer.load_pretrained`).

``running.dataloader=lv`` trains and evaluates an image-text model (CLVP)
on :mod:`..data.image_text` batches ``(image, token ids)``, with the same
reports (``vipant_tpu/train/monitors.py:39-83``).

:class:`VALTrainer` (``vipant_tpu/train/monitors.py:259-370``; parity:
`reference/cvap/monitor/cvalp.py`) trains ``CVALP`` on the AudioSet
contrastive loader (label texts as captions) and reports VA and AL
retrieval at every save, on the eval split and on the test split, with
label-prompt zero-shot P@1 (``running.zero_shot``) over the retrieval
pass's audio embeddings. :class:`VASTrainer` (``:373-451``; parity:
`reference/cvap/monitor/siamese_va.py`) trains ``CVASP`` on the siamese
two-view loader, the views the loss flags ``vv`` / ``aa`` turn off passed
as None, and reports pivot-image <-> audio retrieval.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data import (build_audio_text_dataloader, build_audioset_dataloader,
                    build_audioset_label_map, build_image_audio_dataloader,
                    build_image_text_dataloader, build_xfold_dataloader_list)
from ..data.audioset import label_map_token_matrix
from ..data.device_put import PinnedDevicePut
from ..eval.metrics import (_normalize, cider_d, classification_p1, corpus_bleu, meteor,
                            multilabel_report, one_vs_k_retrieval, rouge_l, symmetric_retrieval,
                            zero_shot_classification)
from ..tokenizer import detokenize_ids
from ..utils import as_config, timed_span
from .checkpoint import extract_model_files, load_checkpoint
from .trainer import Trainer, register_monitor


@register_monitor("LAMonitor")
class LATrainer(Trainer):
    """Audio-text fine-tuning, retrieval and captioning."""

    batch_keys = ("audio", "text")
    reads_worker = None
    grad_cache_methods = ("encode_audio", "encode_text")

    @property
    def image_text(self) -> bool:
        """``running.dataloader=lv``: image-text (CLVP) batches."""
        return str(self.cfg.running.get("dataloader", "al")) == "lv"

    def build_data(self, steps_per_epoch: Optional[int] = None) -> None:
        """The base's training and eval loaders over the audio-text (or,
        with ``running.dataloader=lv``, image-text) datasets, and the test
        split's loader when ``running.test_name`` names one that exists."""
        run = self.cfg.running
        if self.image_text:
            self.batch_keys = ("image", "text")
            self.grad_cache_methods = ("encode_image", "encode_text")
        super().build_data(steps_per_epoch)
        if self._reads_data and run.get("test_name"):
            self.testloader = self._build_testloader()

    def build_loader(self, data_name: str, train: bool, device_put_fn=None):
        build = build_image_text_dataloader if self.image_text else build_audio_text_dataloader
        return build(self.cfg, data_name, train, *self.shard(train), device_put_fn=device_put_fn)

    # ---------------------------------------------------------------- jobs
    def job(self):
        """``model_file=<log>.out``: :meth:`repeated_retrieval`; otherwise
        the base's job, then the ``TEST`` pass
        (`reference/cvap/monitor/clap.py:116-133`)."""
        if str(self.cfg.get("model_file", "") or "").endswith(".out"):
            return self.repeated_retrieval()
        out = super().job()
        if self.testloader is not None:
            self.echo.info("TEST " + self.infer(self.testloader,
                                                samples=self._samples_cap("test_samples")))
        return out

    def mid_train_eval_ok(self, loss: float) -> bool:
        """No save-time eval while the CE is at or above
        ``running.eval_loss_bound`` (default 5; inf evaluates always)
        (`reference/cvap/monitor/clap.py:245,256`: "no need to eval if CE is
        too large")."""
        bound = float(self.cfg.running.get("eval_loss_bound", 5.0))
        return not np.isfinite(bound) or float(loss) < bound

    def repeated_retrieval(self) -> List[str]:
        """The eval report of every step directory the log
        ``{model_root}/{model_name}/{model_file}`` names, each loaded into
        the live state in turn (`reference/cvap/monitor/clap.py:302-311`),
        each under ``running.eval_all_samples`` if set (inf or 0: every
        sample), else the per-save ``eval_samples``."""
        if self.evalloader is None:
            raise ValueError("repeated eval evaluates running.eval_name, which is unset")
        cap = self._eval_all_cap()
        reports = []
        for ckpt in extract_model_files(self._model_file_path()[1]):
            load_checkpoint(ckpt, self.state)
            reports.append(f"{ckpt}: {self.infer(self.evalloader, samples=cap)}")
            self.echo.info(reports[-1])
        return reports

    # ---------------------------------------------------------------- eval
    def infer(self, loader, samples=None, gold_file=None) -> str:
        """The 1-vs-k retrieval report
        (`reference/cvap/module/decoder/loss_head.py:135-169`); a model
        without a text tower reports its decoded captions instead. Neither
        has a gold report: a ``gold_file`` is said once to be ignored."""
        self.warn_gold_unused(gold_file)
        if self.model.text is None:
            return self.caption_report(loader, samples=samples)
        with timed_span(self.timer, "report"):
            data = self.collect_features(loader, samples=samples)
            a, t = data["x1"], data["x2"]
            m = one_vs_k_retrieval(a, t, k=t.shape[0] // a.shape[0])
        ref = m["ref_a2t"]
        return (
            f"A->T: t1 = {m['a2t']['t1']:2.2f} t5 = {m['a2t']['t5']:2.2f} mR = {m['a2t']['mR']:2.2f} "
            f"T->A: t1 = {m['t2a']['t1']:2.2f} t5 = {m['t2a']['t5']:2.2f} mR = {m['t2a']['mR']:2.2f} "
            f"@ {a.shape[0]} | REF A->T R@1 {ref['R@1']:2.2f} R@5 {ref['R@5']:2.2f} "
            f"R@10 {ref['R@10']:2.2f} R@50 {ref['R@50']:2.2f} MED {ref['MED']:2.2f} AVG {ref['AVG']:2.2f}"
        )

    @torch.no_grad()
    def encode_text_dump(self, texts: np.ndarray, out_path: str) -> str:
        """The text embeddings of token ids ``texts`` [n, ctx], 256 a call,
        saved as ``v`` [n, D] to ``out_path`` (npz)
        (`reference/cvap/monitor/clap.py:46-76`)."""
        embs = [self.model.encode_text(self.make_batch(np.asarray(texts[i:i + 256]))[0])
                for i in range(0, len(texts), 256)]
        np.savez(out_path, v=torch.cat(embs).float().cpu().numpy())
        return out_path

    @torch.no_grad()
    def encode_text(self, loader=None, out_root: Optional[str] = None) -> str:
        """Each clip's caption embeddings, ``v`` [k, D], to
        ``{out_root}/{name}.npz``; ``out_root`` defaults to
        ``{data_root}/caption/audiocap/{clip_model_name}`` (lower case), the
        precomputed text embeddings of the trimodal recipe
        (`reference/cvap/monitor/clap.py:46-76`). The eval loader by
        default, else the training loader."""
        run = self.cfg.running
        loader = loader if loader is not None else (self.evalloader or self.loader)
        if out_root is None:
            name = str(run.get("clip_model_name", "model")).lower()
            out_root = os.path.join(str(run.data_root), "caption", "audiocap", name)
        os.makedirs(out_root, exist_ok=True)
        nsample = 0
        for batch in loader:
            names = list(batch["name"])
            n = int(batch.get("_count", len(names)))
            text = batch["text"]
            if torch.is_tensor(text):  # a training batch, placed by the loader
                text = self.device_put.wait(batch)[self.batch_keys.index("text")]
            else:
                text = self.make_batch(text)[0]
            emb = self.model.encode_text(text).float().cpu().numpy()
            if emb.shape[0] % len(names):
                raise ValueError(f"{emb.shape[0]} captions do not tile {len(names)} clips evenly")
            k = emb.shape[0] // len(names)
            for i, name in enumerate(names[:n]):
                np.savez_compressed(os.path.join(out_root, str(name)), v=emb[i * k:(i + 1) * k])
            nsample += n * k
        self.echo.info(f"Saving {nsample} text vectors to `{out_root}`.")
        return out_root

    @torch.no_grad()
    def _decode(self, audio) -> np.ndarray:
        """Token ids [B, max_len_dec + 1] of a batch's fbanks (a host array,
        or the audio tower's input that :meth:`_eval_audio` made): greedy,
        or a beam search of ``running.beam`` > 1 hypotheses."""
        beam = int(self.cfg.running.get("beam", 0) or 0)
        if not torch.is_tensor(audio):
            audio = self.make_batch(audio)[0]
        ids, _ = self.model.decode(audio, beam=beam)
        return ids.cpu().numpy()

    def _eval_audio(self, batch) -> torch.Tensor:
        """A batch's audio through the device frontend (``eval_frontend_args``)."""
        return self.eval_frontend_args(batch)[self.batch_keys.index("audio")]

    def decode_captions(self, loader, max_batches: int = 10) -> List[str]:
        """The decoded captions of the first ``max_batches`` batches."""
        out = []
        for bi, batch in enumerate(loader):
            if bi >= max_batches:
                break
            n = int(batch.get("_count", len(batch["name"])))
            out.extend(detokenize_ids(row[1:]) for row in self._decode(self._eval_audio(batch))[:n])
        return out

    def caption_report(self, loader, samples=None) -> str:
        """Decode the clips and score corpus BLEU-1..4, ROUGE-L, METEOR and
        CIDEr-D against each clip's k gold captions
        (`reference/cvap/module/decoder/loss_more.py:328-371`)."""
        cands, refs = [], []
        for batch in loader:
            if samples is not None and len(cands) >= samples:
                break
            B = batch["audio"].shape[0]
            n = int(batch.get("_count", B))
            text = np.asarray(batch["text"])
            k = text.shape[0] // B
            for i, row in enumerate(self._decode(self._eval_audio(batch))[:n]):
                cands.append(detokenize_ids(row[1:]))
                refs.append([detokenize_ids(text[i * k + j]) for j in range(k)])
        scores = corpus_bleu(cands, refs)
        scores["ROUGE-L"] = rouge_l(cands, refs)
        scores["METEOR"] = meteor(cands, refs)
        scores["CIDEr-D"] = cider_d(cands, refs)
        line = " ".join(f"{k_} = {v:2.2f}" for k_, v in scores.items())
        return f"{line} @ {len(cands)} | e.g.: {'; '.join(cands[:3])}"


@register_monitor("VALMonitor")
class VALTrainer(Trainer):
    """Trimodal V-A-L training on AudioSet (see the module docstring)."""

    batch_keys = ("image", "audio", "text")
    grad_cache_methods = None  # not a two-stream contrastive model
    reads_worker = None
    export_towers = ("image", "audio", "text", "loss")

    def build_data(self, steps_per_epoch: Optional[int] = None) -> None:
        run = self.cfg.running
        self.label_map = build_audioset_label_map(run) if run.get("label_map") else None
        super().build_data(steps_per_epoch)
        # the test split, evaluated at every save (parity:
        # `reference/cvap/monitor/cvalp.py:97-104,254-264`)
        if self._reads_data and not self.eval_mode and run.get("test_name"):
            self.testloader = self._build_testloader()

    def build_loader(self, data_name: str, train: bool, device_put_fn=None):
        pid, nproc = self.shard(train)
        return build_audioset_dataloader(self.cfg, data_name, train, process_id=pid,
                                         num_processes=nproc, label_map=self.label_map,
                                         device_put_fn=device_put_fn)

    def infer(self, loader, samples=None, gold_file=None) -> str:
        """VA (image <-> audio) and AL (audio <-> text) retrieval, and the
        zero-shot P@1 with ``running.zero_shot`` and a label map."""
        self.warn_gold_unused(gold_file)
        data = self.collect_features(loader, samples=samples)
        parts = []
        if "x1" in data and "x2" in data:
            sym = symmetric_retrieval(data["x1"], data["x2"])
            parts.append(f"VA: I->A t1 {sym['12']['t1']:2.2f} A->I t1 {sym['21']['t1']:2.2f}")
        if "x2" in data and "x3" in data:
            sym = symmetric_retrieval(data["x2"], data["x3"])
            parts.append(f"AL: A->L t1 {sym['12']['t1']:2.2f} L->A t1 {sym['21']['t1']:2.2f}")
        if self.label_map is not None and bool(self.cfg.running.get("zero_shot", False)):
            # the retrieval pass's audio embeddings (x2), the same budget
            parts.append(self.zero_shot(loader, samples=samples, audio_embs=data.get("x2")))
        return " | ".join(parts) + f" @ {data['x1'].shape[0]}"

    @torch.no_grad()
    def zero_shot(self, loader, samples=None, audio_embs=None) -> str:
        """Audio -> label-prompt P@1 over the label map
        (`reference/cvap/monitor/cvalp.py:273-300`); ``audio_embs``, the
        loader's audio embeddings in its order, spare the audio tower, and
        the loader is walked for the labels only."""
        ids = label_map_token_matrix(self.label_map)
        text = self.model.encode_text(self.make_batch(ids)[0]).float().cpu().numpy()
        embs, labels, n_got = [], [], 0
        aidx = self.batch_keys.index("audio")
        for batch in loader:
            if audio_embs is not None:
                if n_got >= audio_embs.shape[0]:
                    break
            elif samples is not None and n_got >= samples:
                break
            n = int(batch.get("_count", batch["audio"].shape[0]))
            n_got += n
            labels.append(np.asarray(batch["label"])[:n])
            if audio_embs is None:
                audio = self.eval_frontend_args(batch)[aidx]
                embs.append(self.model.encode_audio(audio).float().cpu().numpy()[:n])
        labels = np.concatenate(labels)
        if audio_embs is not None:
            m = min(audio_embs.shape[0], labels.shape[0])
            audio, labels = np.asarray(audio_embs)[:m], labels[:m]
        else:
            audio = np.concatenate(embs)
        keep = labels >= 0
        p1 = zero_shot_classification(audio[keep], text, labels[keep])
        return f"A->T: p1 = {p1:2.2f}"


@register_monitor("VASMonitor")
class VASTrainer(Trainer):
    """Multi-view siamese VA training (see the module docstring)."""

    batch_keys = ("image", "image_v1", "audio_v1", "image_v2", "audio_v2")
    grad_cache_methods = None  # not a two-stream contrastive model
    reads_worker = None

    def __init__(self, cfg, *args, **kw):
        cfg = as_config(cfg)
        self.use_vv = bool(cfg.model.loss.get("vv", True))
        self.use_aa = bool(cfg.model.loss.get("aa", False))
        super().__init__(cfg, *args, **kw)

    def build_loader(self, data_name: str, train: bool, device_put_fn=None):
        return build_image_audio_dataloader(self.cfg, data_name, train, *self.shard(train),
                                            device_put_fn=device_put_fn)

    def views(self, args: Tuple) -> Tuple:
        """The model's args with a view that is off as None (`reference/
        cvap/monitor/siamese_va.py:23-62`)."""
        image, image_v1, audio_v1, image_v2, audio_v2 = args
        return (image, image_v1, audio_v1, image_v2 if self.use_vv else None,
                audio_v2 if self.use_aa else None)

    def train_step(self, *batch, audio_len=None):
        return super().train_step(*self.views(batch), audio_len=audio_len)

    @torch.no_grad()
    def infer(self, loader, samples=None, gold_file=None) -> str:
        """Pivot-image <-> audio-view retrieval on the eval batches
        (`reference/cvap/monitor/siamese_va.py:154-180`)."""
        self.warn_gold_unused(gold_file)
        vs, aas, n_got = [], [], 0
        for batch in loader:
            if samples is not None and n_got >= samples:
                break
            args = self.eval_frontend_args(batch)
            n = int(batch.get("_count", len(batch["name"])))
            vs.append(self.model.encode_pivot_image(args[0]).float().cpu().numpy()[:n])
            aas.append(self.model.encode_audio_view(args[2]).float().cpu().numpy()[:n])
            n_got += n
        v, a = np.concatenate(vs), np.concatenate(aas)
        sym = symmetric_retrieval(v, a)
        return f"I->A: t1 = {sym['12']['t1']:2.2f} A->I: t1 = {sym['21']['t1']:2.2f} @ {v.shape[0]}"


@register_monitor("ASMonitor")
class ASTrainer(Trainer):
    """AudioSet multi-label classification and zero-shot
    (``vipant_tpu/train/monitors.py:453-609``; parity:
    `reference/cvap/monitor/audioset_clf.py`): ``ASClassifier`` over
    :func:`..data.build_audioset_dataloader` batches ``(image, audio,
    multi-hot labels)``, the label map (ontology order, eval-present labels)
    read before the model so its heads get the label count; the test split
    evaluated at every save; the sigmoid multilabel report; label-prompt
    zero-shot; an audio-embedding dump."""

    batch_keys = ("image", "audio", "label")
    grad_cache_methods = None  # not a two-stream contrastive model
    reads_worker = None

    def build_data(self, steps_per_epoch: Optional[int] = None) -> None:
        run = self.cfg.running
        self.label_map = build_audioset_label_map(run)
        self.output_dim = len(self.label_map)
        super().build_data(steps_per_epoch)
        if self._reads_data and not self.eval_mode and run.get("test_name"):
            self.testloader = self._build_testloader()

    def build_loader(self, data_name: str, train: bool, device_put_fn=None):
        pid, nproc = self.shard(train)
        return build_audioset_dataloader(self.cfg, data_name, train, process_id=pid,
                                         num_processes=nproc, label_map=self.label_map,
                                         device_put_fn=device_put_fn)

    @torch.no_grad()
    def infer(self, loader, samples=None, gold_file=None) -> str:
        """The multilabel report over the sigmoid scores
        (`reference/cvap/module/decoder/loss_more.py:92-131`), the padded
        last batch trimmed by its ``_count``."""
        self.warn_gold_unused(gold_file)
        scores, labels, n_got = [], [], 0
        for batch in loader:
            if samples is not None and n_got >= samples:
                break
            n = int(batch.get("_count", batch["label"].shape[0]))
            n_got += n
            s = self.model(*self.eval_frontend_args(batch), train=False)
            scores.append(s.float().cpu().numpy()[:n])
            labels.append(np.asarray(batch["label"])[:n])
        m = multilabel_report(np.concatenate(scores), np.concatenate(labels))
        return (
            f"Mac-AP = {m['Mac-AP']:2.2f} Mic-AP = {m['Mic-AP']:2.2f} wAP = {m['wAP']:2.2f} "
            f"mAP = {m['mAP']:2.2f} mAUC = {m['mAUC']:2.2f} mP = {m['mP']:2.2f} mR = {m['mR']:2.2f}"
        )

    @torch.no_grad()
    def encode_label_texts(self) -> np.ndarray:
        """The label prompts' embeddings [n_label, D], 128 prompts a call
        (`reference/cvap/monitor/audioset_clf.py:362-375`)."""
        ids = label_map_token_matrix(self.label_map)
        embs = [self.model.encode_text(self.make_batch(ids[i:i + 128])[0]).float().cpu().numpy()
                for i in range(0, len(ids), 128)]
        return np.concatenate(embs)

    @torch.no_grad()
    def _audio_embeddings(self, batch) -> np.ndarray:
        audio = self.eval_frontend_args(batch)[self.batch_keys.index("audio")]
        return self.model.encode_audio(audio).float().cpu().numpy()

    def zero_shot(self, loader, samples=None) -> str:
        """Audio against label-prompt similarity -> the multilabel mAP and
        mAUC (`reference/cvap/monitor/audioset_clf.py:377-404`)."""
        text = _normalize(self.encode_label_texts())
        scores, labels, n_got = [], [], 0
        for batch in loader:
            if samples is not None and n_got >= samples:
                break
            n = int(batch.get("_count", batch["label"].shape[0]))
            n_got += n
            scores.append(_normalize(self._audio_embeddings(batch)[:n]) @ text.T)
            labels.append(np.asarray(batch["label"])[:n])
        m = multilabel_report(np.concatenate(scores), np.concatenate(labels))
        return f"zero-shot mAP = {m['mAP']:2.2f} mAUC = {m['mAUC']:2.2f}"

    def repeated_zero_shot(self) -> List[str]:
        """The zero-shot report of every step directory the log
        ``model_file`` names (`reference/cvap/monitor/audioset_clf.py:406-418`)."""
        cap = self._eval_all_cap()
        reports = []
        for ckpt in extract_model_files(self._model_file_path()[1]):
            load_checkpoint(ckpt, self.state)
            reports.append(f"{ckpt}: {self.zero_shot(self.evalloader, samples=cap)}")
            self.echo.info(reports[-1])
        return reports

    def encode_audios_dump(self, loader, out_path: str) -> str:
        """Every clip's audio embedding, ``v`` [N, D] with ``names``, to
        ``out_path`` (npz; `reference/cvap/monitor/audioset_clf.py:70-98`)."""
        embs, names = [], []
        for batch in loader:
            n = int(batch.get("_count", len(batch["name"])))
            embs.append(self._audio_embeddings(batch)[:n])
            names.extend(batch["name"][:n])
        np.savez(out_path, v=np.concatenate(embs), names=np.asarray(names))
        return out_path


@register_monitor("ESCMonitor")
class ESCTrainer(Trainer):
    """ESC-50 / US8K / AudioSet-eval / VoxCeleb2 x-fold classification and
    zero-shot (``vipant_tpu/train/monitors.py:612-785``; parity:
    `reference/cvap/monitor/esc50_clf.py`): ``ESClassifier`` over
    :func:`..data.build_xfold_dataloader_list`'s folds. Supervised, each
    fold trains a fresh model and optimizer (:meth:`reinitialize`) for
    ``running.epochs``, scores P@1 on its held-out fold after every epoch
    and shuts its loaders down; :meth:`summary_report` gives the mean ± std
    at the best common epoch. ``running.zero_shot`` or ``eval=True``: the
    pooled zero-shot P@1 over every fold (:meth:`standard_zero_shot`), with
    the multi-prompt collapse map; so do the eval-only sets.

    The folds are read whether or not the trainer trains (the label count
    sizes the head); ``steps_per_epoch`` only sets the schedule's epoch
    length (else each fold's training loader's length does)."""

    batch_keys = ("audio", "label")
    grad_cache_methods = None  # not a two-stream contrastive model
    reads_worker = None

    def build_data(self, steps_per_epoch: Optional[int] = None) -> None:
        run = self.cfg.running
        training = not self.eval_mode and not bool(run.get("zero_shot", False))
        self.device_put = PinnedDevicePut(self.batch_keys, self.device) if training else None
        self.folds, self.classes, self.label_ids, extras = build_xfold_dataloader_list(
            self.cfg, device_put_fn=self.device_put)
        # the multi-prompt zero-shot collapse map (prompt row -> class id); the
        # VoxCeleb2 speaker-id -> face-file map is carried as the JAX package does
        self.zs_label_map = extras.get("label_map")
        self.faces = extras.get("faces")
        self.output_dim = len(self.classes)
        self.loader, self._evalloader = self.folds[0]
        self._fixed_steps = steps_per_epoch
        self.steps_per_epoch = self._fold_steps()

    def _fold_steps(self) -> int:
        if self._fixed_steps is not None:
            return max(int(self._fixed_steps), 1)
        return max(len(self.loader), 1) if self.loader is not None else 1

    def _build_evalloader(self):
        return None  # each fold brings its own

    def close(self) -> None:
        for train_loader, eval_loader in self.folds:
            for loader in (train_loader, eval_loader):
                if loader is not None:
                    loader.shutdown()

    def reinitialize(self) -> None:
        """A fresh model and optimizer for the current fold, the schedule
        over its training loader's length; the step count restarts at 0."""
        self.steps_per_epoch = self._fold_steps()
        self.build_model()
        self.build_optimizer()
        self.global_step = 0

    @torch.no_grad()
    def encode_label_texts(self) -> np.ndarray:
        return self.model.encode_text(self.make_batch(self.label_ids)[0]).float().cpu().numpy()

    @torch.no_grad()
    def _fold_apply(self, loader, method: str) -> Tuple[np.ndarray, np.ndarray]:
        """``method`` of the model over an eval loader's audio, the padded
        last batch trimmed by its ``_count``: (outputs, labels)."""
        fn = getattr(self.model, method)
        outs, labels = [], []
        for batch in loader:
            n = int(batch.get("_count", batch["audio"].shape[0]))
            o = fn(self.eval_frontend_args(batch)[0])
            outs.append((o.float() if o.is_floating_point() else o).cpu().numpy()[:n])
            labels.append(np.asarray(batch["label"])[:n])
        return np.concatenate(outs), np.concatenate(labels)

    def _fold_predictions(self, loader) -> Tuple[np.ndarray, np.ndarray]:
        return self._fold_apply(loader, "predictions")

    def infer(self, loader, samples=None, gold_file=None) -> str:
        """Supervised P@1 on a fold's eval loader (folds are small: the
        sample budget is not applied)."""
        self.warn_gold_unused(gold_file)
        preds, labels = self._fold_predictions(loader)
        p1 = 100.0 * float(np.mean(preds == labels)) if len(labels) else 0.0
        return f"P@1 = {p1:2.2f} @ {len(labels)}"

    def zero_shot(self, loader) -> float:
        """One fold's zero-shot P@1 (`reference/cvap/monitor/esc50_clf.py:260-292`)."""
        audio, labels = self._fold_apply(loader, "encode_audio")
        return zero_shot_classification(audio, self.encode_label_texts(), labels,
                                        label_map=self.zs_label_map)

    def standard_zero_shot(self) -> float:
        """Zero-shot P@1 pooled over every fold's eval clips
        (`reference/cvap/monitor/esc50_clf.py:294-325`)."""
        text = self.encode_label_texts()
        audios, labels = zip(*(self._fold_apply(ev, "encode_audio") for _, ev in self.folds))
        p1 = zero_shot_classification(np.concatenate(audios), text, np.concatenate(labels),
                                      label_map=self.zs_label_map)
        self.echo.info(f"A->T: p1 = {p1:2.2f} @ {sum(len(l) for l in labels)}")
        return p1

    def repeated_zero_shot(self) -> List[str]:
        """The pooled zero-shot of every step directory the log
        ``model_file`` names (`reference/cvap/monitor/esc50_clf.py:327-337`)."""
        reports = []
        for ckpt in extract_model_files(self._model_file_path()[1]):
            load_checkpoint(ckpt, self.state)
            reports.append(f"{ckpt}: p1 = {self.standard_zero_shot():2.2f}")
        return reports

    def job(self):
        """Zero-shot (``running.zero_shot``, ``eval=True``, or an eval-only
        set), else the supervised x-fold protocol
        (`reference/cvap/monitor/esc50_clf.py:43-120`)."""
        if bool(self.cfg.running.get("zero_shot", False)) or self.eval_mode:
            return self.standard_zero_shot()
        report_by_fold = []
        for fi, (train_loader, eval_loader) in enumerate(self.folds):
            if train_loader is None:  # eval-only sets (AudioSet, VoxCeleb2)
                return self.standard_zero_shot()
            self.loader, self._evalloader = train_loader, eval_loader
            self.reinitialize()
            report_by_epoch = []
            for ie in range(int(self.cfg.running.epochs)):
                self.loader.set_epoch(ie)
                self.epoch(ie)
                report_by_epoch.append(classification_p1(*self._fold_predictions(eval_loader)))
            report_by_fold.append(report_by_epoch)
            self.echo.info(f"fold {fi}: p1 = {report_by_epoch[-1]:2.2f} "
                           f"(best {max(report_by_epoch):2.2f})")
            train_loader.shutdown()
            if eval_loader is not None:
                eval_loader.shutdown()
        return self.summary_report(np.asarray(report_by_fold))

    def summary_report(self, report: np.ndarray) -> float:
        """[folds, epochs] P@1 -> the mean (returned) ± std at the best
        common epoch, and the mean ± std of each fold's best
        (`reference/cvap/monitor/esc50_clf.py:104-120`)."""
        nfold, nepoch = report.shape[:2]
        self.echo.info(f"Total {nepoch} epochs for each of {nfold} folds.")
        best_epoch = int(report.sum(0).argmax())
        best = report[:, best_epoch]
        mean, std = float(best.mean()), float(best.std())
        self.echo.info(f"Best mean and std: {mean:2.2f} \\pm {std:2.2f} in the {best_epoch}th epoch.")
        max_p, max_e = report.max(axis=1), report.argmax(axis=1)
        self.echo.info(f"Max mean and std: {max_p.mean():2.2f} \\pm {max_p.std():2.2f} "
                       f"in the {max_e.tolist()}th epoch.")
        return mean
