"""The trainer on one device: VA pre-training (CVAP) from a JSONL index
with its epoch loop, save-time eval and checkpoints; and the training step
alone for VA, audio-text retrieval and audio captioning (CLAP).

Counterpart of ``vipant_tpu/train/trainer.py:Trainer`` (the ``VAMonitor``):
config -> data loaders (:mod:`..data`: host workers decode the wav and the
frame JPEG, featurise and augment; :class:`..data.device_put.PinnedDevicePut`
copies each batch to the card from pinned memory on a side stream) -> task
model with seeded random weights -> trainable/frozen split
(:func:`..models.tunable_mask`) -> optimizer (:func:`..optim.build_optimizer`)
-> :class:`TrainState`. :meth:`Trainer.learn` runs the epochs: the step,
the loss peeped every ``peep_rate`` steps (``halt_on_nan``,
``metrics_jsonl``), a save and a retrieval eval every ``save_rate`` steps,
at the end of warmup and at the schedule's milestones (non-LARS) and at
each epoch's end (``save_epoch``), and a ``torch.profiler`` window
(``profile``). Checkpoints are ``torch.save`` step directories
(:mod:`.checkpoint`); ``model_file=<step dir>`` resumes from one exactly,
mid-epoch too: the restored step fast-forwards the deterministic epoch order
to its batch. ``eval=True`` runs the retrieval eval alone,
``running.audio.eval_norms`` the fbank-statistics job.

A trainer built with an explicit ``steps_per_epoch`` reads no data: its
caller drives :meth:`Trainer.train_step` on batches it provides, as
``bench.py`` drives the JAX step on device arrays.

A CLAP model with a captioning decoder trains ``forward_caption`` (audio
tower -> feature grid -> ``SeqGenerationHead`` -> ``LMLossHead``) on batches
of ``(fbank, token ids)`` unless ``running.retrieval`` asks for the
contrastive loss and the model has a text tower: the rule of the JAX
package's ``LAMonitor.loss_adapter``. ``model.image.int8_frozen=True`` runs
the frozen image tower on the forward-only int8 kernels.

Not ported yet, and refused when asked for (ROADMAP.md's queue A names the
item that ports each): CLIP and reference ``.pth`` weights, ``export_pth``
and ``async_ckpt`` (A7); the on-device frontend (A8); CLAP's epoch loop and
the other monitors (A10, A11, A12); the gradient cache, ZeRO and every mesh
axis beyond one device (A15).

Usage::

    from vipant_tpu_torch.train import Trainer
    Trainer([...overrides..., "worker=CVAP", "eval=False",
             "running.data_root=/data/va", "running.data_name=train"]).learn()  # on the card
    tr = Trainer([...overrides...], steps_per_epoch=1000)   # no data: the step alone
    metrics = tr.train_step(*tr.make_batch(images_np, audios_np))   # {"loss", "grad_norm", "lr"}
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..data import build_image_audio_dataloader
from ..data.device_put import PinnedDevicePut
from ..data.image_audio import refuse_unported as refuse_unported_data
from ..eval.metrics import format_retrieval_report, grouped_pnr, symmetric_retrieval
from ..models import build_main_model, init_weights, tunable_mask
from ..optim import build_optimizer, partition_params
from ..utils import (AverageMeter, PhaseTimer, as_config, numel, require_device, run_root,
                     seed_all_rng, setup_logger)
from .checkpoint import load_checkpoint, save_checkpoint
from .state import TrainState
from .step import eval_step, train_step

# the JAX package's other monitors -> the ROADMAP.md queue-A item that ports them
_UNPORTED_MONITORS = {"LAMonitor": "A10", "ASMonitor": "A11", "ESCMonitor": "A11",
                      "VALMonitor": "A12", "VASMonitor": "A12"}
_LOGGER = "vipant_tpu_torch"


def build_monitor(cfg, **kw):
    """``cfg.monitor`` -> its trainer: ``VAMonitor`` is :class:`Trainer`;
    the others raise, naming the queue item that ports them."""
    cfg = as_config(cfg)
    name = str(cfg.monitor)
    if name != "VAMonitor":
        item = _UNPORTED_MONITORS.get(name)
        raise NotImplementedError(f"monitor {name!r} is not ported yet"
                                  + (f" (ROADMAP.md queue A, {item})" if item else ""))
    return Trainer(cfg, **kw)


def _refuse_unported(cfg) -> None:
    model_file = str(cfg.get("model_file", "") or "")
    if model_file.endswith(".pth"):
        raise NotImplementedError(
            f"model_file {model_file!r}: reference .pth checkpoints are not ported yet "
            "(ROADMAP.md queue A, A7)")
    if model_file.endswith(".out"):
        raise NotImplementedError(
            f"model_file {model_file!r}: evaluating the checkpoints a log names is not ported "
            "yet (ROADMAP.md queue A, A10)")
    for key in ("async_ckpt", "export_pth"):
        if bool(cfg.get(key, False)):
            raise NotImplementedError(f"{key} is not ported yet (ROADMAP.md queue A, A7)")
    run = cfg.get("running", Config({}))
    refuse_unported_data(run)
    gc = run.get("grad_cache", None)
    if gc is not None and bool(gc.get("alive", False)):
        raise NotImplementedError("the gradient cache is not ported yet (ROADMAP.md queue A, A15)")
    mesh = cfg.get("mesh", Config({}))
    if bool(mesh.get("zero", False)):
        raise NotImplementedError("ZeRO is not ported yet (ROADMAP.md queue A, A15)")
    for axis in ("model", "pipe", "seq"):
        if int(mesh.get(axis, 1)) > 1:
            raise NotImplementedError(
                f"mesh.{axis} > 1 is not ported yet (one device; ROADMAP.md queue A, A15)")


class Trainer:
    """Builds the data, the model, the trainable/frozen split and the
    optimizer from ``cfg`` on ``device`` (the card by default; raises when
    there is none). ``cfg`` is a composed config or a list of overrides.
    ``steps_per_epoch``: given, no data is read and it sets the schedules'
    epoch length; else the training loader's length sets it."""

    batch_keys: Tuple[str, ...] = ("image", "audio")

    def __init__(self, cfg: Union[Config, Sequence[str]], device: Union[str, torch.device] = "cuda",
                 steps_per_epoch: Optional[int] = None):
        self.cfg = as_config(cfg)
        _refuse_unported(self.cfg)
        self.device = require_device(device, "Trainer")
        seed_all_rng(int(self.cfg.seed))
        self.out_dir = os.path.join(run_root(self.cfg.alias_root), str(self.cfg.model_name))
        self.echo = setup_logger(None, verbose=bool(self.cfg.get("verbose", False)), name=_LOGGER)
        self.timer = PhaseTimer()
        self.eval_mode = bool(self.cfg.get("eval", False))
        self.global_step = 0
        self._profiler = None  # the ``profile`` window, open across epochs
        self.run_id = f"{int(time.time())}-{os.getpid()}"  # metrics.jsonl rows

        self.timer.start("build")
        self.build_data(steps_per_epoch)
        self.build_model()
        self.build_optimizer()
        self.timer.stop("build")
        self.echo.info(
            f"model params: {numel(self.trainable) + numel(self.frozen):,} "
            f"(tunable {numel(self.trainable):,}) on {self.device}")

    # ------------------------------------------------------------------ data
    def build_data(self, steps_per_epoch: Optional[int] = None) -> None:
        """The training loader (a training run of CVAP: ``eval=False`` and
        ``running.data_name``), placing batches through pinned memory; the
        eval loader (``running.eval_name``), built here for a training run
        and at first use otherwise. None of either with ``steps_per_epoch``."""
        run = self.cfg.get("running", Config({}))
        self._reads_data = steps_per_epoch is None and self.cfg.worker == "CVAP"
        self.loader = self._evalloader = self.device_put = None
        if self._reads_data and not self.eval_mode and run.get("data_name"):
            self.device_put = PinnedDevicePut(self.batch_keys, self.device)
            self.loader = build_image_audio_dataloader(
                self.cfg, str(run.data_name), True, device_put_fn=self.device_put)
            self._evalloader = self._build_evalloader()  # fails here, not at the first save
        self.steps_per_epoch = len(self.loader) if self.loader is not None else max(
            int(steps_per_epoch or 1), 1)

    def _build_evalloader(self):
        run = self.cfg.get("running", Config({}))
        if not (self._reads_data and run.get("eval_name")):
            return None
        return build_image_audio_dataloader(self.cfg, str(run.eval_name), False)

    @property
    def evalloader(self):
        if self._evalloader is None:
            self._evalloader = self._build_evalloader()
        return self._evalloader

    def close(self) -> None:
        """Stop the loaders' worker processes (they start again when needed)."""
        for loader in (self.loader, self._evalloader):
            if loader is not None:
                loader.shutdown()

    # ----------------------------------------------------------------- model
    def build_model(self) -> None:
        cfg = self.cfg
        self.resume_from = self._checkpoint_path()
        seed = int(cfg.seed)
        self.model = build_main_model(cfg, device=self.device)
        init_weights(self.model, torch.Generator(device=self.device).manual_seed(seed))
        self.trainable, self.frozen = partition_params(self.model, tunable_mask(cfg, self.model))
        self.loss_kwargs = {}
        if hasattr(self.model, "decoder"):  # CLAP: retrieval needs a text tower
            has_text = self.model.text is not None
            run = cfg.get("running", Config({}))
            self.loss_kwargs["retrieval"] = self.model.decoder is None or bool(
                run.get("retrieval", has_text))

    def _checkpoint_path(self) -> Optional[str]:
        """The step directory ``model_file`` names under
        ``model_root/model_name``, or None; a configured but missing one
        raises rather than train from random weights."""
        model_file = str(self.cfg.get("model_file", "") or "")
        if not model_file:
            return None
        path = os.path.join(run_root(self.cfg.model_root), str(self.cfg.model_name), model_file)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"model_file {model_file!r} not found at {path!r}")
        return path

    # ------------------------------------------------------------- optimizer
    def build_optimizer(self) -> None:
        opt = build_optimizer(self.cfg.optimizer, self.steps_per_epoch, self.trainable)
        self.state = TrainState(
            step=0, model=self.model, trainable=self.trainable, frozen=self.frozen,
            optimizer=opt, generator=torch.Generator(device=self.device).manual_seed(int(self.cfg.seed)),
            loss_kwargs=self.loss_kwargs,
        )
        if self.resume_from is not None:
            load_checkpoint(self.resume_from, self.state)
            self.global_step = self.state.step
            self.echo.info(f"resumed from {self.resume_from} at step {self.global_step}")

    # ---------------------------------------------------------------- batch
    def make_batch(self, *arrays: np.ndarray):
        """Host arrays -> fp32 tensors on the device (integer arrays keep
        their dtype: token ids)."""
        out = []
        for a in arrays:
            t = torch.as_tensor(np.ascontiguousarray(a))
            out.append(t.to(self.device, torch.float32 if t.is_floating_point() else t.dtype))
        return tuple(out)

    def train_step(self, *batch: torch.Tensor) -> Dict[str, object]:
        return train_step(self.state, *batch)

    # ---------------------------------------------------------------- learn
    def learn(self):
        """The job the config asks for: the fbank-statistics job
        (``running.audio.eval_norms``), the retrieval eval (``eval=True``),
        or training over ``running.epochs`` from the training loader."""
        run = self.cfg.running
        if self.cfg.worker != "CVAP":
            raise NotImplementedError(f"the epoch loop of worker {self.cfg.worker!r} is not ported "
                                      "yet (ROADMAP.md queue A, A10)")
        self.echo = setup_logger(self.out_dir, verbose=bool(self.cfg.get("verbose", False)),
                                 name=_LOGGER)
        try:
            if "audio" in run and bool(run.audio.get("eval_norms", False)):
                # (parity: `reference/cvap/monitor/cvap.py:43-65`)
                return self.eval_norms(self.evalloader or self.loader)
            if self.eval_mode:
                if self.evalloader is None:
                    raise ValueError("eval=True evaluates running.eval_name, which is unset")
                report = self.infer(self.evalloader, samples=self._samples_cap("eval_samples"))
                self.echo.info(report)
                return report
            if self.loader is None:
                raise ValueError(
                    "learn() trains from running.data_name (with eval=False and no "
                    "steps_per_epoch given); this trainer has no training loader")
            epochs = int(run.epochs)
            # mid-epoch exact resume: the restored global_step fast-forwards to
            # the right epoch and batch offset of the deterministic epoch order
            start_epoch, skip = divmod(self.global_step, self.steps_per_epoch)
            if skip and start_epoch < epochs:
                self.echo.info(f"resuming mid-epoch: epoch {start_epoch}, skipping {skip} batches")
            for ie in range(start_epoch, epochs):
                self.loader.set_epoch(ie, start_batch=skip if ie == start_epoch else 0)
                self.epoch(ie)
                if bool(run.get("save_epoch", False)):
                    self.save()
                    self.mid_train_evals()
        finally:
            if self._profiler is not None:  # the window outlasted the run
                self._end_profile()
            self.close()

    def epoch(self, ie: int) -> None:
        run = self.cfg.running
        peep_rate = int(run.get("peep_rate", 100))
        save_rate = int(float(run.get("save_rate", 1e9)))
        prof = self.cfg.get("profile")
        prof_on = prof is not None and bool(prof.get("alive", False))
        halt_on_nan = bool(self.cfg.get("halt_on_nan", True))
        # the reference forces an eval+save at the exact step warmup reaches
        # the base lr (`reference/cvap/monitor/clap.py:190-200`) and where a
        # per-batch MultiStepLR crosses a milestone — non-LARS path only
        opt = self.cfg.get("optimizer")
        warmup_done_step = -1
        milestone_steps: set = set()
        if opt is not None and not bool(opt.get("use_lars", False)):
            if bool(opt.get("warmup", False)):
                warmup_done_step = int(opt.get("warmup_steps", 0))
            if bool(opt.get("batch_sch", False)):
                milestone_steps = {int(m) * self.steps_per_epoch for m in (opt.get("steps", []) or [])}
        meter = AverageMeter(window=peep_rate)
        nsample = 0
        t_epoch = time.time()
        self.timer.start("data")
        for batch in self.loader:
            args = self.device_put.wait(batch)
            self.timer.stop("data")
            self.timer.start("model")
            if prof_on and self.global_step + 1 == int(prof.get("start_step", 10)):
                activities = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                self._profiler = torch.profiler.profile(activities=activities)
                self._profiler.start()
            metrics = train_step(self.state, *args)
            self.global_step += 1
            if self._profiler is not None and self.global_step == int(
                    prof.get("start_step", 10)) + int(prof.get("num_steps", 5)):
                self._end_profile()
            nsample += len(batch["name"])
            self.timer.stop("model")

            if self.global_step % peep_rate == 0:
                loss = float(metrics["loss"])  # host read (sync point)
                if not np.isfinite(loss):
                    self.echo.error(f"non-finite loss {loss} at step {self.global_step}")
                    if halt_on_nan:
                        raise FloatingPointError(f"loss became {loss} at step {self.global_step}")
                meter.update(loss)
                lr = float(self.state.optimizer.schedule(self.global_step))
                dt = time.time() - t_epoch
                self.echo.info(
                    f"epoch {ie} step {self.global_step} loss {loss:.4f} (avg {meter.avg:.4f}) "
                    f"lr {lr:.2e} {nsample / dt:.1f} samples/s ({self.timer.summary()})")
                if bool(self.cfg.get("metrics_jsonl", False)):
                    # `run` tells rows re-logged after a crash-resume apart;
                    # non-finite values become null so every line stays JSON
                    fin = lambda v: float(v) if np.isfinite(v) else None
                    os.makedirs(self.out_dir, exist_ok=True)
                    with open(os.path.join(self.out_dir, "metrics.jsonl"), "a") as f:
                        f.write(json.dumps({
                            "run": self.run_id, "ts": time.time(), "epoch": ie,
                            "step": self.global_step, "loss": fin(loss),
                            "loss_avg": fin(meter.avg), "lr": fin(lr),
                            "samples_per_sec": nsample / max(dt, 1e-9),
                        }) + "\n")
            force_eval = self.global_step == warmup_done_step or self.global_step in milestone_steps
            if force_eval or (save_rate > 0 and self.global_step % save_rate == 0):
                self.save()
                self.mid_train_evals()
            self.timer.start("data")
        self.timer.stop("data")
        self.echo.info(f"epoch {ie} done: {nsample} samples in {time.time() - t_epoch:.1f}s")

    def _end_profile(self) -> None:
        """Stop the ``profile`` window and write its Chrome trace."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        prof_dir = self.cfg.profile.get("dir") or os.path.join(self.out_dir, "profile")
        trace = os.path.join(run_root(prof_dir), f"trace_{self.global_step:08d}.json")
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        self._profiler.export_chrome_trace(trace)
        self._profiler = None
        self.echo.info(f"profiler trace written to {trace}")

    # ---------------------------------------------------------------- eval
    def _samples_cap(self, key: str) -> Optional[float]:
        """``running.eval_samples`` / ``running.test_samples`` budget, or
        None when unset/inf/non-positive (= evaluate everything)."""
        run = self.cfg.get("running")
        v = run.get(key) if run is not None else None
        if v is None:
            return None
        v = float(v)
        return v if np.isfinite(v) and v > 0 else None

    def mid_train_evals(self) -> None:
        """Save-time eval of the eval loader under its sample budget
        (parity: `reference/cvap/monitor/cvap.py:246-272`); the VA trainer
        evaluates at every save, whatever the loss."""
        if self.evalloader is not None:
            self.echo.info(self.infer(self.evalloader, samples=self._samples_cap("eval_samples")))

    def collect_features(self, loader, samples: Optional[float] = None) -> Dict[str, object]:
        """Encode the loader's items (``x1`` image, ``x2`` audio, fp32
        numpy; ``names``); pad rows of a ``pad_last`` batch are dropped.
        ``samples`` caps the items, overshooting by at most one batch
        (`reference/cvap/monitor/cvap.py:252-254`)."""
        feats: Dict[str, List[np.ndarray]] = {}
        names: List[str] = []
        for batch in loader:
            if samples is not None and len(names) >= samples:
                break
            out = eval_step(self.model, *self.make_batch(*(batch[k] for k in self.batch_keys)))
            n_items = len(batch["name"])
            n_true = int(batch.get("_count", n_items))
            for key, val in zip(("x1", "x2", "x3"), out):
                arr = val.float().cpu().numpy()
                if n_true < n_items:  # drop pad rows (k per item)
                    arr = arr[: n_true * (arr.shape[0] // n_items)]
                feats.setdefault(key, []).append(arr)
            names.extend(batch["name"][:n_true])
        return {k: np.concatenate(v) for k, v in feats.items()} | {"names": names}

    def infer(self, loader, samples=None, gold_file=None) -> str:
        """Paired retrieval eval (I↔A), plus per-class precision/recall
        when a gold file is configured (parity:
        `reference/cvap/monitor/cvap.py:246-272`)."""
        self.timer.start("report")
        data = self.collect_features(loader, samples=samples)
        sym = symmetric_retrieval(data["x1"], data["x2"])
        n = data["x1"].shape[0]
        msg = ""
        if gold_file is None:
            gold_file = self.cfg.running.get("gold_file") if "running" in self.cfg else None
        if gold_file:
            msg = " " + self._gold_report(data, gold_file)
        self.timer.stop("report")
        return format_retrieval_report(sym, n) + msg

    def _gold_report(self, data, gold_file: str) -> str:
        """Per-class P/R/mAP via label clustering from a gold JSONL index
        (records ``{"id", "labels": [...]}``)."""
        classname_by_sample = {}
        with open(gold_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                classname_by_sample[rec["id"]] = ",".join(sorted(rec.get("labels", [])))
        names = data["names"]
        if any(nm not in classname_by_sample for nm in names):
            return "(gold file does not cover eval samples)"
        sample_by_classname: Dict[str, List[str]] = {}
        for nm in names:
            sample_by_classname.setdefault(classname_by_sample[nm], []).append(nm)
        x1 = data["x1"] / np.linalg.norm(data["x1"], axis=-1, keepdims=True)
        x2 = data["x2"] / np.linalg.norm(data["x2"], axis=-1, keepdims=True)
        order_12 = np.argsort(-(x1 @ x2.T), axis=1)
        order_21 = np.argsort(-(x2 @ x1.T), axis=1)
        m12 = grouped_pnr(order_12, names, classname_by_sample, sample_by_classname)
        m21 = grouped_pnr(order_21, names, classname_by_sample, sample_by_classname)
        return (
            f"| I->A P@1 {m12['P@1']:2.2f} mAP {m12['mAP']:2.2f} "
            f"A->I P@1 {m21['P@1']:2.2f} mAP {m21['mAP']:2.2f}"
        )

    # ----------------------------------------------------------------- save
    def collect_model_export(self) -> Dict[str, torch.Tensor]:
        """Reference-compat weight export: the audio tower and the loss
        head (`reference/cvap/model/cvap.py:42-46`), chosen by the exact
        first component of each name."""
        return {k: p for k, p in self.model.named_parameters()
                if k.split(".", 1)[0] in ("audio", "loss")}

    def save(self) -> str:
        """Write ``{alias_root}/{model_name}/{step:08d}/`` (:mod:`.checkpoint`)."""
        path = save_checkpoint(
            self.out_dir, self.global_step, self.state, cfg=self.cfg,
            model_only=self.collect_model_export(),
            keep_last=int(self.cfg.get("keep_last_ckpts", 0) or 0))
        self.echo.info(f"saving the checkpoint to {path}")
        return path

    def eval_norms(self, loader) -> Tuple[float, float]:
        """Dataset fbank statistics job
        (parity: `reference/cvap/monitor/cvap.py:43-65`)."""
        total, total_sq, count = 0.0, 0.0, 0
        for batch in loader:
            a = batch["audio"]
            if torch.is_tensor(a):  # a training batch, placed by the loader
                a = self.device_put.wait(batch)[self.batch_keys.index("audio")].cpu().numpy()
            # pad_last eval loaders repeat the final item to the fixed
            # batch shape; statistics must not count the padding rows
            n_true = int(batch.get("_count", a.shape[0]))
            a = a[:n_true]
            total += float(a.sum())
            total_sq += float((a ** 2).sum())
            count += a.size
        mean = total / count
        std = float(np.sqrt(total_sq / count - mean ** 2))
        self.echo.info(f"fbank norms: mean {mean:.8f} std {std:.8f}")
        return mean, std

