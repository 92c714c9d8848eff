"""The trainer on one device: VA pre-training (CVAP) from a JSONL index
with its epoch loop, save-time eval and checkpoints; and the training step
alone for VA, audio-text retrieval and audio captioning (CLAP). It is the
base of the other monitors (:mod:`.monitors`: ``LAMonitor``,
``VALMonitor``, ``VASMonitor``, ``ASMonitor``, ``ESCMonitor``), which
:func:`build_monitor` picks by ``cfg.monitor``.

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
each epoch's end (``save_epoch``), each gated on the step's loss by
:meth:`Trainer.mid_train_eval_ok` (always open here), and a
``torch.profiler`` window (``profile``). Checkpoints are ``torch.save``
step directories (:mod:`.checkpoint`); ``model_file=<step dir>`` resumes
from one exactly, mid-epoch too: the restored step fast-forwards the
deterministic epoch order to its batch. ``eval=True`` runs the retrieval
eval alone, ``running.audio.eval_norms`` the fbank-statistics job.

A trainer built with an explicit ``steps_per_epoch`` reads no data: its
caller drives :meth:`Trainer.train_step` on batches it provides, as
``bench.py`` drives the JAX step on device arrays.

A CLAP model with a captioning decoder trains ``forward_caption`` (audio
tower -> feature grid -> ``SeqGenerationHead`` -> ``LMLossHead``) on batches
of ``(fbank, token ids)`` unless ``running.retrieval`` asks for the
contrastive loss and the model has a text tower: the rule of the JAX
package's ``LAMonitor.loss_adapter``. ``model.image.int8_frozen=True`` runs
the frozen image tower on the forward-only int8 kernels.

The device frontend (:meth:`Trainer.device_frontend`, before every training
step and, through :meth:`Trainer.eval_frontend_args`, every eval) turns
what the data layer ships into the towers' inputs on the card:
``running.audio.on_device`` waveforms (fp32, or int16 PCM with
``running.audio.wav_int16``) into the normalised fbank
(:mod:`..ops.fbank`) with SpecAugment at train time (:mod:`..ops.specaugment`,
drawn from the train state's generator), ``running.audio.ship_int16`` /
``ship_bf16`` fbanks into fp32, and ``running.image_uint8`` frames into
CLIP-normalised fp32 (:mod:`..ops.frontend`).

Weights (:meth:`Trainer.load_pretrained`, before the optimizer takes the
parameters), by the priority checkpoint > meme > CLIP > random: a reference
``.pth`` ``model_file`` (a VA checkpoint's audio tower for AT fine-tuning)
or a step directory to resume; else CLIP weights (``running.clip_model_root``
/ ``clip_model_name``) into the towers that are not DeiT, then a DeiT
tower's ``meme_path`` (a timm ``deit_base_distilled_patch16_224`` file,
:meth:`Trainer.load_meme`); else the seeded random init. ``export_pth``
writes each save's weight export as a reference ``.pth`` too (not for
ResNet and DeiT towers, which have no such layout). ``async_ckpt`` writes
the checkpoints in the background (:mod:`.checkpoint`); ``learn`` waits for
the last one.

A tower with ``patchout`` draws its token subset from the train state's
generator, after SpecAugment's draws of the same step. ResNet towers'
BatchNorm statistics are buffers, carried like Barlow's below; a training
step moves them in every tower, the frozen ones too, as the JAX step does.

Siamese ties (``running.siamese``, and ``CVASP``'s view tower) share the
image tower's ``Parameter`` objects with the tying stages after the weights
load (:func:`..models.tie_model`); the mask and the optimizer see each
shared tensor once, under the image tower's name, and the save's weight
export writes it under every tower that holds it. A loss head's running
statistics (Barlow's BatchNorm) are buffers of the model that the train
state and its checkpoints carry.

Not ported yet, and refused when asked for (ROADMAP.md's queue A, A15): the
gradient cache, ZeRO and every mesh axis beyond one device.

Usage::

    from vipant_tpu_torch.train import Trainer
    Trainer([...overrides..., "worker=CVAP", "eval=False",
             "running.data_root=/data/va", "running.data_name=train"]).learn()  # on the card
    build_monitor([...overrides..., "monitor=LAMonitor", "platform=cpu"]).learn()  # on the CPU
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

from ..ckpt.from_jax import resnet_towers
from ..ckpt.loading import (apply_reference_ckpt, clip_weights_path, load_tower, model_towers,
                            report_sources)
from ..ckpt.reference_port import load_torch_file
from ..config import Config
from ..data import build_image_audio_dataloader
from ..data.device_put import PinnedDevicePut
from ..data.image_audio import FBANK_INT16_SCALE, fbank_params_from_cfg
from ..data.image_audio import refuse_unported as refuse_unported_data
from ..eval.metrics import format_retrieval_report, grouped_pnr, symmetric_retrieval
from ..models import build_main_model, init_weights, port_model_from_clip, tie_model, tunable_mask
from ..ops.fbank import fbank_fixed_len
from ..ops.frontend import device_normalize_image
from ..ops.specaugment import spec_augment
from ..optim import build_optimizer, partition_params
from ..utils import (AverageMeter, PhaseTimer, as_config, numel, require_device, run_root,
                     seed_all_rng, setup_logger)
from .checkpoint import load_checkpoint, save_checkpoint, wait_for_saves
from .state import TrainState
from .step import eval_step, train_step

MONITORS: Dict[str, type] = {}
_LOGGER = "vipant_tpu_torch"


def register_monitor(*names):
    def deco(cls):
        for n in names:
            MONITORS[n] = cls
        return cls
    return deco


def build_monitor(cfg, **kw):
    """``cfg.monitor`` -> its trainer (:data:`MONITORS`), on the card unless
    ``device`` or ``platform=cpu`` asks for the CPU; an unknown name raises."""
    cfg = as_config(cfg)
    name = str(cfg.monitor)
    if name not in MONITORS:
        raise ValueError(f"unknown monitor {name!r} ({', '.join(sorted(MONITORS))})")
    if str(cfg.get("platform") or "") == "cpu":
        kw.setdefault("device", "cpu")
    return MONITORS[name](cfg, **kw)


def _refuse_unported(cfg) -> None:
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
    reads_worker: Optional[str] = "CVAP"  # the worker whose data this monitor reads; None: any

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
        self.testloader = None  # monitors with a test split set it in build_data
        self.output_dim = None  # the classifiers' label count, set in build_data
        self._last_metrics = None  # the last step's, for the gate of the epoch-end eval
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
        """The training loader (a training run: ``eval=False`` and
        ``running.data_name``), placing batches through pinned memory; the
        eval loader (``running.eval_name``), built here for a training run
        and at first use otherwise. None of either with ``steps_per_epoch``,
        nor for a worker whose data this monitor does not read (the VA
        trainer reads CVAP's)."""
        run = self.cfg.get("running", Config({}))
        self._reads_data = steps_per_epoch is None and self.reads_worker in (None, self.cfg.worker)
        self.loader = self._evalloader = self.device_put = None
        if self._reads_data and not self.eval_mode and run.get("data_name"):
            self.device_put = PinnedDevicePut(self.batch_keys, self.device)
            self.loader = self.build_loader(str(run.data_name), True, device_put_fn=self.device_put)
            self._evalloader = self._build_evalloader()  # fails here, not at the first save
        self.steps_per_epoch = len(self.loader) if self.loader is not None else max(
            int(steps_per_epoch or 1), 1)

    def build_loader(self, data_name: str, train: bool, device_put_fn=None):
        return build_image_audio_dataloader(self.cfg, data_name, train, device_put_fn=device_put_fn)

    def _build_evalloader(self):
        run = self.cfg.get("running", Config({}))
        if not (self._reads_data and run.get("eval_name")):
            return None
        return self.build_loader(str(run.eval_name), False)

    @property
    def evalloader(self):
        if self._evalloader is None:
            self._evalloader = self._build_evalloader()
        return self._evalloader

    def close(self) -> None:
        """Stop the loaders' worker processes (they start again when needed)."""
        for loader in (self.loader, self._evalloader, self.testloader):
            if loader is not None:
                loader.shutdown()

    # ----------------------------------------------------------------- model
    def build_model(self) -> None:
        cfg = self.cfg
        self.resume_from = self._checkpoint_path()
        seed = int(cfg.seed)
        self.model = build_main_model(cfg, device=self.device, output_dim=self.output_dim)
        init_weights(self.model, torch.Generator(device=self.device).manual_seed(seed))
        self.load_pretrained()
        if not self.resume_from and not str(cfg.get("model_file", "") or "").endswith(".pth"):
            self.load_meme()
        self.ties = tie_model(cfg, self.model)
        self.trainable, self.frozen = partition_params(
            self.model, tunable_mask(cfg, self.model, self.ties))
        for name, tower in self.model.named_children():
            if getattr(tower, "int8_frozen", False) and any(p.requires_grad for p in tower.parameters()):
                raise ValueError(f"model.{name}.int8_frozen: the tower holds trainable parameters "
                                 "(a siamese tie trains its tied stages); the int8 trunk is "
                                 "forward-only")
        self.loss_kwargs = {}
        if hasattr(self.model, "decoder"):  # CLAP: retrieval needs a text tower
            has_text = self.model.text is not None
            run = cfg.get("running", Config({}))
            self.loss_kwargs["retrieval"] = self.model.decoder is None or bool(
                run.get("retrieval", has_text))

    def _model_file_path(self) -> Tuple[str, str]:
        model_file = str(self.cfg.get("model_file", "") or "")
        return model_file, os.path.join(run_root(self.cfg.model_root), str(self.cfg.model_name),
                                        model_file)

    def _checkpoint_path(self) -> Optional[str]:
        """The step directory ``model_file`` names under
        ``model_root/model_name``, or None (no ``model_file``, a log for
        repeated eval, or a reference ``.pth``: :meth:`load_pretrained`); a
        configured but missing one raises rather than train from random
        weights."""
        model_file, path = self._model_file_path()
        if not model_file or model_file.endswith((".out", ".pth")):  # a log names checkpoints
            return None
        if not os.path.isdir(path):
            raise FileNotFoundError(f"model_file {model_file!r} not found at {path!r}")
        return path

    def load_pretrained(self) -> None:
        """Weights before the optimizer takes the parameters, by the JAX
        trainer's priority (``vipant_tpu/train/trainer.py:205-236``): a
        reference ``.pth`` ``model_file`` into the towers it holds (a missing
        one raises); a step directory resumes in :meth:`build_optimizer`;
        CLIP weights (``running.clip_model_root`` / ``clip_model_name``) only
        when ``model_file`` is empty; else the seeded random init. Each
        tower's source is logged."""
        model_file, path = self._model_file_path()
        sources: Dict[str, str] = {}
        if model_file.endswith(".pth"):
            if not os.path.exists(path):
                raise FileNotFoundError(f"model_file {model_file!r} not found at {path!r}")
            loaded = apply_reference_ckpt(self.model, path, echo=self.echo)
            sources = {t: f"reference checkpoint {path}" for t in loaded}
        elif self.resume_from is not None:
            sources = {t: f"train state {self.resume_from}" for t in model_towers(self.model)}
        elif not model_file:
            clip_path = clip_weights_path(self.cfg)
            if clip_path is not None:
                loaded = port_model_from_clip(self.model, load_torch_file(clip_path)[1])
                sources = {t: f"CLIP weights {clip_path}" for t in loaded}
        report_sources(self.echo, self.model, sources)

    def load_meme(self) -> None:
        """The "meme" DeiT init (``vipant_tpu/train/trainer.py:238-271``):
        a DeiT tower whose config names a ``meme_path`` takes that timm
        ``deit_base_distilled_patch16_224`` file (:func:`..ckpt.deit_port.port_deit`)
        over its init. A missing file warns and keeps the current init. The
        caller skips it when a checkpoint loads (a ``.pth`` or a resume)."""
        from ..ckpt.deit_port import port_deit
        from ..nn.deit import DeiTTower

        for name in ("image", "audio"):
            mcfg = self.cfg.model.get(name) if "model" in self.cfg else None
            tower = getattr(self.model, name, None)
            path = str(mcfg.get("meme_path", "") or "") if mcfg is not None else ""
            if not path or not isinstance(tower, DeiTTower):
                continue
            if not os.path.exists(path):
                self.echo.warning(f"failed to load the meme {mcfg.get('meme_name')!r} from "
                                  f"{path!r}: not found; keeping the current init")
                continue
            load_tower(tower, port_deit(load_torch_file(path)[1], tower), f"meme {path} -> {name}")
            self.echo.info(f"initialized the {name} tower from the meme DeiT weights {path}")

    # ------------------------------------------------------------- optimizer
    def build_optimizer(self) -> None:
        opt = build_optimizer(self.cfg.optimizer, self.steps_per_epoch, self.trainable)
        self.state = TrainState(
            step=0, model=self.model, trainable=self.trainable, frozen=self.frozen,
            optimizer=opt, generator=torch.Generator(device=self.device).manual_seed(int(self.cfg.seed)),
            loss_kwargs=self.loss_kwargs, buffers=dict(self.model.named_buffers()),
        )
        for module in self.model.modules():  # patchout draws from the train state's stream
            if hasattr(module, "patchout_generator"):
                module.patchout_generator = self.state.generator
        if self.resume_from is not None:
            load_checkpoint(self.resume_from, self.state)
            self.global_step = self.state.step
            self.echo.info(f"resumed from {self.resume_from} at step {self.global_step}")

    # ---------------------------------------------------------------- batch
    def make_batch(self, *arrays: np.ndarray):
        """Host arrays (or tensors) -> tensors on the device: floating ones as fp32,
        integer arrays in their own dtype (token ids; and what the device
        frontend converts: int16 waveforms and fbank codes, uint8 frames,
        bf16 fbanks as their uint16 bits)."""
        out = []
        for a in arrays:
            if a is None:  # a view that is off (the siamese monitor)
                out.append(None)
                continue
            t = a if torch.is_tensor(a) else torch.as_tensor(np.ascontiguousarray(a))
            out.append(t.to(self.device, torch.float32 if t.is_floating_point() else t.dtype))
        return tuple(out)

    def train_step(self, *batch: torch.Tensor, audio_len=None) -> Dict[str, object]:
        """One training step on a batch placed on the device, through the
        device frontend when the config ships waveforms or compact formats
        (``audio_len``: the waveforms' true lengths, the loader's
        ``batch["audio_len"]``)."""
        if self.needs_device_frontend:
            batch = self.device_frontend(batch, train=True, audio_len=audio_len)
        return train_step(self.state, *batch)

    # ------------------------------------------------------- device frontend
    def _audio_flag(self, key: str) -> bool:
        run = self.cfg.get("running")
        return (run is not None and "audio" in run and bool(run.audio.get(key, False))
                and any(k.startswith("audio") for k in self.batch_keys))

    @property
    def on_device_audio(self) -> bool:
        """Waveforms ship, and the fbank runs on the card."""
        return self._audio_flag("on_device")

    @property
    def image_uint8(self) -> bool:
        run = self.cfg.get("running")
        return (run is not None and bool(run.get("image_uint8", False))
                and any(k.startswith("image") for k in self.batch_keys))

    @property
    def audio_int16_fbank(self) -> bool:
        """Precomputed fbanks ship as int16 codes (the npz dataset)."""
        return self._audio_flag("ship_int16")

    @property
    def audio_bf16_fbank(self) -> bool:
        """Precomputed fbanks ship as bf16 bits (the npz dataset)."""
        return self._audio_flag("ship_bf16")

    @property
    def needs_device_frontend(self) -> bool:
        return (self.on_device_audio or self.image_uint8 or self.audio_int16_fbank
                or self.audio_bf16_fbank)

    def _frontend_settings(self):
        """(fbank params, max frames, norms or None, SpecAugment's frequency
        and time params; 0 when ``transform_fbank`` is off)."""
        acfg = self.cfg.running.audio
        norms = tuple(acfg.get("norms", []) or []) or None
        freq_p = time_p = 0
        if bool(acfg.get("transform_fbank", False)):
            for entry in acfg.get("fbank_transforms", []) or []:
                if entry[0] == "FrequencyMasking":
                    freq_p = int(entry[1][0])
                elif entry[0] == "TimeMasking":
                    time_p = int(entry[1][0])
        return fbank_params_from_cfg(acfg), int(self.cfg.running.max_audio_len), norms, freq_p, time_p

    def device_frontend(self, args: Sequence[torch.Tensor], train: bool = True,
                        audio_len=None) -> Tuple:
        """The model's args with every image-kind key's uint8 frames
        normalised and every audio-kind key through :meth:`_frontend_audio`
        (counterpart of ``vipant_tpu/train/trainer.py:device_frontend``);
        ``audio_len`` goes with every audio-kind key (the siamese views are
        crops of one clip)."""
        out = list(args)
        for i, key in enumerate(self.batch_keys):
            x = out[i]
            if not torch.is_tensor(x):
                continue
            if key.startswith("image") and x.dtype == torch.uint8:
                out[i] = device_normalize_image(x)
            elif key.startswith("audio"):
                out[i] = self._frontend_audio(x, train, audio_len)
        return tuple(out)

    def _frontend_audio(self, wav: torch.Tensor, train: bool, audio_len=None) -> torch.Tensor:
        """One audio stream: int16 fbank codes [B, 1, T, M] times 1/256;
        bf16 bits [B, 1, T, M] to fp32; a waveform [B, N] (int16 PCM times
        1/32767, then its mean over the padded length removed: the host
        zero-meaned the clip over its true length, so this takes only the
        rounding's DC) to the normalised fbank [B, 1, T, M], the frames past
        each clip's true length (``audio_len`` [B], when given) zeroed as the
        host path pads, with SpecAugment at train time, each call drawing
        its own masks from the train state's generator; anything else
        passes."""
        if wav.dim() == 4 and wav.dtype == torch.int16:
            return wav.float() * (1.0 / FBANK_INT16_SCALE)
        if wav.dim() == 4 and wav.dtype == torch.uint16:
            return wav.view(torch.bfloat16).float()
        if wav.dim() != 2:  # featurised already
            return wav
        params, max_len, norms, freq_p, time_p = self._frontend_settings()
        if wav.dtype == torch.int16:
            wav = wav.float() * (1.0 / 32767.0)
            if bool(self.cfg.running.audio.get("zero_mean_wf", True)):
                wav = wav - wav.mean(dim=-1, keepdim=True)
        if audio_len is not None:
            audio_len = torch.as_tensor(np.asarray(audio_len)).to(wav.device)
        feats = fbank_fixed_len(wav, params, max_len, norms=norms, num_samples=audio_len)
        if train and (freq_p or time_p):
            feats = spec_augment(feats, self.state.generator, freq_p, time_p)
        return feats[:, None]

    def eval_frontend_args(self, batch) -> Tuple[torch.Tensor, ...]:
        """A batch dict -> the model's args on the device, through the device
        frontend when the config ships waveforms or compact formats. Every
        eval path takes its args here: a raw waveform [B, N] handed to
        ``encode_audio`` would be read as a precomputed embedding."""
        args = self.make_batch(*(batch[k] for k in self.batch_keys))
        if self.needs_device_frontend:
            with torch.no_grad():
                args = self.device_frontend(args, train=False, audio_len=batch.get("audio_len"))
        return args

    # ---------------------------------------------------------------- learn
    def learn(self):
        """Run :meth:`job` with the log written to ``{out_dir}/train_0.out``,
        then stop the loaders' workers."""
        self.echo = setup_logger(self.out_dir, verbose=bool(self.cfg.get("verbose", False)),
                                 name=_LOGGER)
        try:
            out = self.job()
            wait_for_saves()  # the last async save commits (and its error surfaces) here
            return out
        finally:
            if self._profiler is not None:  # the window outlasted the run
                self._end_profile()
            self.close()

    def job(self):
        """The job the config asks for: the fbank-statistics job
        (``running.audio.eval_norms``), the retrieval eval (``eval=True``),
        or training over ``running.epochs`` from the training loader."""
        run = self.cfg.running
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
                # gated on the epoch's last loss, as the save inside the loop
                last = self._last_metrics
                self.mid_train_evals(float(last["loss"]) if last is not None else float("-inf"))

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
        # a composite loss head's parts (``loss_ce``, ``loss_bce``), read at the peeps
        comp_meters: Dict[str, AverageMeter] = {}
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
            metrics = self._last_metrics = self.train_step(*args, audio_len=batch.get("audio_len"))
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
                comp = ""
                for k in sorted(metrics):
                    if k.startswith("loss_"):
                        m = comp_meters.setdefault(k, AverageMeter(window=peep_rate))
                        m.update(float(metrics[k]))
                        comp += f"{k[5:]} {m.avg:.3f} "
                lr = float(self.state.optimizer.schedule(self.global_step))
                dt = time.time() - t_epoch
                self.echo.info(
                    f"epoch {ie} step {self.global_step} loss {loss:.4f} (avg {meter.avg:.4f}) "
                    f"{comp}lr {lr:.2e} {nsample / dt:.1f} samples/s ({self.timer.summary()})")
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
                loss = float(metrics["loss"])  # the gate's, whether or not peeped this step
                self.save()
                self.mid_train_evals(loss)
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

    def mid_train_evals(self, loss: float) -> bool:
        """Save-time eval of the eval loader, then of the test split's (a
        ``TEST`` report, under ``running.test_samples``) when the monitor
        has one, when :meth:`mid_train_eval_ok` lets ``loss`` through; a
        skipped eval is logged. Returns whether it ran (parity:
        `reference/cvap/monitor/cvap.py:246-272`, `clap.py:245-262`,
        `audioset_clf.py:300-321`)."""
        if not self.mid_train_eval_ok(loss):
            self.echo.info(f"save-time eval skipped: loss {loss:.3f} above the eval "
                           "gate (running.eval_loss_bound, see mid_train_eval_ok)")
            return False
        if self.evalloader is not None:
            self.echo.info(self.infer(self.evalloader, samples=self._samples_cap("eval_samples")))
        if self.testloader is not None:
            self.echo.info("TEST " + self.infer(self.testloader, samples=self._samples_cap("test_samples"),
                                                gold_file=self.cfg.running.get("gold_file_test")))
        return True

    def mid_train_eval_ok(self, loss: float) -> bool:
        """Whether the save-time eval runs at this loss: always, for the VA
        trainer."""
        return True

    def _eval_all_cap(self) -> Optional[float]:
        """The sample budget of an evaluate-every-checkpoint pass:
        ``running.eval_all_samples`` if set (inf or 0: every sample), else
        the per-save ``eval_samples`` (said once in the log)."""
        if self.cfg.running.get("eval_all_samples") is not None:
            return self._samples_cap("eval_all_samples")
        cap = self._samples_cap("eval_samples")
        if cap is not None:
            self.echo.info(f"eval-all pass capped at {int(cap)} samples per checkpoint "
                           "(running.eval_samples; set running.eval_all_samples=inf "
                           "for full-split reports)")
        return cap

    def _build_testloader(self):
        """The test split's loader (``running.test_name``); a split that is
        not on disk is skipped with a line in the log, as the reference did
        (`reference/cvap/monitor/clap.py:105-111`); any other error raises."""
        name = str(self.cfg.running.test_name)
        try:
            return self.build_loader(name, False)
        except (FileNotFoundError, OSError) as e:
            self.echo.info(f"test split '{name}' unavailable, skipping: {e}")
            return None

    def warn_gold_unused(self, gold_file) -> None:
        """A monitor without a gold report says once that it ignores a
        configured ``gold_file``."""
        if gold_file and not getattr(self, "_gold_warned", False):
            self._gold_warned = True
            self.echo.info(f"gold_file '{gold_file}' is not supported by {type(self).__name__}; ignored")

    def collect_features(self, loader, samples: Optional[float] = None) -> Dict[str, object]:
        """Encode the loader's items through the device frontend (``x1``
        image, ``x2`` audio, fp32 numpy; ``names``); pad rows of a
        ``pad_last`` batch are dropped.
        ``samples`` caps the items, overshooting by at most one batch
        (`reference/cvap/monitor/cvap.py:252-254`)."""
        feats: Dict[str, List[np.ndarray]] = {}
        names: List[str] = []
        for batch in loader:
            if samples is not None and len(names) >= samples:
                break
            out = eval_step(self.model, *self.eval_frontend_args(batch))
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
    export_towers: Tuple[str, ...] = ("audio", "loss")

    def collect_model_export(self) -> Dict[str, torch.Tensor]:
        """Reference-compat weight export: the towers of
        :attr:`export_towers`, the audio tower and the loss head here
        (`reference/cvap/model/cvap.py:42-46`), chosen by the exact first
        component of each name; a tied parameter under every tower that
        holds it (the JAX package's ``restore_tied``)."""
        return {k: p for k, p in self.model.named_parameters(remove_duplicate=False)
                if k.split(".", 1)[0] in self.export_towers}

    def save(self) -> str:
        """Write ``{alias_root}/{model_name}/{step:08d}/`` (:mod:`.checkpoint`),
        with ``export_pth`` also the weight export as a reference-format
        ``{step:08d}.pth`` there (``vipant_tpu/train/trainer.py:986-1000``);
        an exported ResNet or DeiT tower has no ``.pth`` layout, and then the
        save warns and writes none."""
        export = self.collect_model_export()
        export_pth = bool(self.cfg.get("export_pth", False))
        if export_pth and {"resnet", "deit"} & {getattr(getattr(self.model, n, None), "backbone", None)
                                                for n in self.export_towers}:
            self.echo.warning("reference .pth export skipped: ResNet and DeiT towers have no "
                              "reference .pth layout")
            export_pth = False
        path = save_checkpoint(
            self.out_dir, self.global_step, self.state, cfg=self.cfg, model_only=export,
            keep_last=int(self.cfg.get("keep_last_ckpts", 0) or 0), export_pth=export_pth,
            async_save=bool(self.cfg.get("async_ckpt", False)),
            resnet_towers=resnet_towers(self.model))
        self.echo.info(f"saving the checkpoint to {path}")
        return path

    def eval_norms(self, loader) -> Tuple[float, float]:
        """Dataset fbank statistics job, on the fbanks the towers would read
        (through the device frontend when waveforms ship)
        (parity: `reference/cvap/monitor/cvap.py:43-65`)."""
        total, total_sq, count = 0.0, 0.0, 0
        for batch in loader:
            if "_copied" in batch:  # a training batch, placed by the loader
                self.device_put.wait(batch)
            a = self.eval_frontend_args(batch)[self.batch_keys.index("audio")].cpu().numpy()
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


register_monitor("VAMonitor")(Trainer)
