"""The monitors beyond VA pre-training: ``LAMonitor``, audio-text
fine-tuning, retrieval and captioning on one device.

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

Not ported yet, and refused (ROADMAP.md's queue A): the image-text loader
``running.dataloader=lv`` (A12); the packed ``pak*`` datasets (A11);
initialising from a VA checkpoint or CLIP weights (A7).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..data import build_audio_text_dataloader
from ..eval.metrics import cider_d, corpus_bleu, meteor, one_vs_k_retrieval, rouge_l
from ..tokenizer import detokenize_ids
from ..utils import run_root
from .checkpoint import extract_model_files, load_checkpoint
from .trainer import Trainer, register_monitor


@register_monitor("LAMonitor")
class LATrainer(Trainer):
    """Audio-text fine-tuning, retrieval and captioning."""

    batch_keys = ("audio", "text")
    reads_worker = None

    def build_data(self, steps_per_epoch: Optional[int] = None) -> None:
        """The base's training and eval loaders over the audio-text
        datasets, and the test split's loader when ``running.test_name``
        names one that exists."""
        run = self.cfg.running
        if str(run.get("dataloader", "al")) == "lv":
            raise NotImplementedError("running.dataloader=lv: the image-text loader is not "
                                      "ported yet (ROADMAP.md queue A, A12)")
        super().build_data(steps_per_epoch)
        if self._reads_data and run.get("test_name"):
            # a test split that is not on disk is skipped, as the reference did
            # (`reference/cvap/monitor/clap.py:105-111`); any other error raises
            name = str(run.test_name)
            try:
                self.testloader = self.build_loader(name, False)
            except (FileNotFoundError, OSError) as e:
                self.echo.info(f"test split '{name}' unavailable, skipping: {e}")

    def build_loader(self, data_name: str, train: bool, device_put_fn=None):
        return build_audio_text_dataloader(self.cfg, data_name, train, device_put_fn=device_put_fn)

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

    def mid_train_evals(self, loss: float) -> bool:
        """The base's save-time eval, then the test split's under
        ``running.test_samples`` (`reference/cvap/monitor/clap.py:245-262`)."""
        ran = super().mid_train_evals(loss)
        if ran and self.testloader is not None:
            self.echo.info("TEST " + self.infer(self.testloader, samples=self._samples_cap("test_samples"),
                                                gold_file=self.cfg.running.get("gold_file_test")))
        return ran

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
        log_path = os.path.join(run_root(self.cfg.model_root), str(self.cfg.model_name),
                                str(self.cfg.model_file))
        if self.cfg.running.get("eval_all_samples") is not None:
            cap = self._samples_cap("eval_all_samples")
        else:
            cap = self._samples_cap("eval_samples")
            if cap is not None:
                self.echo.info(f"eval-all pass capped at {int(cap)} samples per checkpoint "
                               "(running.eval_samples; set running.eval_all_samples=inf "
                               "for full-split reports)")
        reports = []
        for ckpt in extract_model_files(log_path):
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
        if gold_file and not getattr(self, "_gold_warned", False):
            self._gold_warned = True
            self.echo.info(f"gold_file '{gold_file}' is not supported by {type(self).__name__}; ignored")
        if self.model.text is None:
            return self.caption_report(loader, samples=samples)
        self.timer.start("report")
        data = self.collect_features(loader, samples=samples)
        a, t = data["x1"], data["x2"]
        m = one_vs_k_retrieval(a, t, k=t.shape[0] // a.shape[0])
        self.timer.stop("report")
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
