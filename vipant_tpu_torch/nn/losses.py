"""Loss heads.

Counterpart of ``vipant_tpu/nn/losses.py``: the symmetric InfoNCE
``CELossHead`` (``:39-89``) with its learnable temperature ``logit_scale``
(initialised at log 1/0.07, clamped at ``scale_max`` after the exp); the
captioning ``LMLossHead`` (``:416-434``), cross-entropy over the decoder's
logits with the same learnable scale, not clamped; and the classifier heads
(``:92-188``, ``:345-416``): ``ClassificationHead`` (LayerNorm, linear,
scaled CE), ``BCELossHead`` and ``BCHingeLossHead`` (an (LayerNorm, linear)
chain, then BCE-with-logits or a pairwise hinge over the sigmoid scores) and
``ImagineAndClassifyLossHead`` (the BCE head plus a CE between an a2v
projection of the audio embedding and the image embedding). The heads'
linear layers are plain products over [B, 512] in fp32, outside any kernel,
as the JAX package leaves them to XLA. Their submodules carry the JAX
package's names (``ln``, ``linear``, ``mlp.ln_0``, ``mlp.dense_0``,
``a2v.dense_0``, ``bce.mlp...``), so :mod:`..ckpt.from_jax` only renames
``kernel`` / ``scale`` to ``weight``.

The trimodal and siamese heads (``:189-343``): ``VALCELossHead`` and
``VACELossHead`` sum a ``CELossHead`` of its own (``ce_va``, ``ce_lv``,
``ce_al``; ``ce_vp``, ``ce_ap``, ``ce_va``, ``ce_vv``, ``ce_aa``), each with
its own temperature, over each active pair whose inputs are present, and
return ``(total, {pair: loss})``; ``BarlowLossHead`` is the Barlow Twins
projector (bias-free denses, :class:`BatchNorm` and ReLU between them) and
the identity-matching loss over the batch-standardised cross-correlation;
``BarlowCELossHead`` is ``ce + lambd_barlow * barlow`` over its nested
``ce`` and ``barlow`` heads. :class:`BatchNorm` is flax's ``nn.BatchNorm``
(momentum 0.99, eps 1e-5, the variance E[x^2] - E[x]^2 clipped at 0 and
biased, the running statistics updated from the batch's in train mode and
read in eval), not ``torch.nn.BatchNorm1d`` (unbiased running variance,
``momentum`` the other way round). A tower's BatchNorm under data
parallelism (``data_group`` set by the trainer) takes the global batch's
statistics from the ranks' sums; the loss heads' see the gathered batch.
Its running ``mean`` and ``var`` are buffers: the train state, its
checkpoints and :mod:`..ckpt.from_jax` (the JAX ``batch_stats`` collection)
carry them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import Registry
from .layers import LayerNorm, lecun_normal_

LOSS_HEADS = Registry("LOSS_HEADS")

LOGIT_SCALE_INIT = math.log(1.0 / 0.07)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@LOSS_HEADS.register()
class CELossHead(nn.Module):
    """CE(logits) + CE(logits^T) over the similarity matrix, with
    ``logits = min(exp(logit_scale), scale_max) * x1 . x2^T``."""

    def __init__(self, scaling: bool = True, scale_max: Optional[float] = 100.0, device=None):
        super().__init__()
        self.scale_max = scale_max
        self.logit_scale = (
            nn.Parameter(torch.tensor(LOGIT_SCALE_INIT, device=device)) if scaling else None
        )

    def init_weights(self, generator: torch.Generator) -> None:
        if self.logit_scale is not None:
            nn.init.constant_(self.logit_scale, LOGIT_SCALE_INIT)

    def scale(self) -> torch.Tensor:
        s = self.logit_scale if self.logit_scale is not None else torch.zeros(())
        s = torch.exp(s.float())
        if self.scale_max is not None:
            s = torch.clamp(s, max=self.scale_max)
        return s

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, normalized: bool = False) -> torch.Tensor:
        if not normalized:
            x1, x2 = l2_normalize(x1), l2_normalize(x2)
        logits = self.scale().to(x1.device) * torch.matmul(x1.float(), x2.float().t())
        labels = torch.arange(x1.shape[0], device=x1.device)
        return F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)


@LOSS_HEADS.register()
class LMLossHead(nn.Module):
    """Captioning cross-entropy over decoder logits [B, T, V] against
    targets [B, T], pad (id 0) ignored: the mean over the non-pad targets
    (over 1 when there is none). With ``scaling`` the logits are multiplied
    by ``exp(logit_scale)`` (initialised at log 1/0.07, never clamped) before
    the fp32 log-softmax."""

    def __init__(self, scaling: bool = True, device=None):
        super().__init__()
        self.logit_scale = (
            nn.Parameter(torch.tensor(LOGIT_SCALE_INIT, device=device)) if scaling else None
        )

    def init_weights(self, generator: torch.Generator) -> None:
        if self.logit_scale is not None:
            nn.init.constant_(self.logit_scale, LOGIT_SCALE_INIT)

    def forward(self, logits: torch.Tensor, targets: torch.Tensor, mesh=None) -> torch.Tensor:
        """``mesh``: the data mesh when the ranks hold parts of the batch.
        The loss is then the global batch's, ``sum(nll * mask) / max(sum(mask),
        1)`` over every rank's tokens (ranks pad differently, so a mean of
        the ranks' means would be another loss), and its grad is ``ranks``
        times this rank's part, so that the mean of the ranks' grads is the
        global loss's grad (:mod:`..parallel.collectives`)."""
        logits = logits.float()
        if self.logit_scale is not None:
            logits = torch.exp(self.logit_scale.float()) * logits
        # token ids come as int32 from the loader; the loss takes int64 class indices
        nll = F.cross_entropy(logits.flatten(0, -2), targets.flatten().long(), reduction="none")
        mask = (targets.flatten() != 0).float()
        if mesh is None or not mesh.parallel:
            return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        from ..parallel.collectives import all_reduce_sum

        num = (nll * mask).sum()
        den = torch.clamp(all_reduce_sum(mask.sum(), mesh), min=1.0)
        part = num * float(mesh.data) / den
        whole = all_reduce_sum(num.detach(), mesh) / den
        return part + (whole - part).detach()


class _LogitScale(nn.Module):
    """The learnable temperature of the classifier heads: ``exp(logit_scale)``
    (initialised at log 1/0.07), clamped at ``scale_max`` when given; 1
    without ``scaling`` (``vipant_tpu/nn/losses.py:_ScaleMixin``)."""

    def __init__(self, scaling: bool, scale_max: Optional[float], device=None):
        super().__init__()
        self.scale_max = scale_max
        self.logit_scale = (
            nn.Parameter(torch.tensor(LOGIT_SCALE_INIT, device=device)) if scaling else None
        )

    def init_weights(self, generator: torch.Generator) -> None:
        if self.logit_scale is not None:
            nn.init.constant_(self.logit_scale, LOGIT_SCALE_INIT)

    def scale(self) -> torch.Tensor:
        s = torch.exp(self.logit_scale.float()) if self.logit_scale is not None else torch.ones(())
        return s if self.scale_max is None else torch.clamp(s, max=self.scale_max)


class Dense(nn.Linear):
    """flax ``nn.Dense`` with fp32 params: the input is promoted to fp32
    (a bf16 embedding meets fp32 weights as in the JAX package), the kernel
    initialised lecun-normal (truncated at 2 std, variance 1 / fan_in), the
    bias at zero."""

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight, self.bias)


class _MLPChain(nn.Module):
    """(LayerNorm -> Dense)* over ``sizes``, the last Dense with a bias only
    when ``final_bias`` (``vipant_tpu/nn/losses.py:92-108``; submodules
    ``ln_{i}``, ``dense_{i}``)."""

    def __init__(self, in_dim: int, sizes: Sequence[int], final_bias: bool = True, device=None):
        super().__init__()
        self.n = len(sizes)
        for i, size in enumerate(sizes):
            self.add_module(f"ln_{i}", LayerNorm(in_dim, device=device))
            self.add_module(f"dense_{i}", Dense(in_dim, int(size), bias=final_bias or i < self.n - 1,
                                                device=device))
            in_dim = int(size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(getattr(self, f"ln_{i}")(x))
        return x


@LOSS_HEADS.register()
class ClassificationHead(_LogitScale):
    """LayerNorm + linear classifier (``vipant_tpu/nn/losses.py:111-131``):
    train, ``CE(exp(logit_scale) * logits, labels)`` in fp32; eval, the
    logits."""

    def __init__(self, in_dim: int, num_labels: int, scaling: bool = True,
                 scale_max: Optional[float] = None, device=None):
        super().__init__(scaling, scale_max, device=device)
        self.ln = LayerNorm(in_dim, device=device)
        self.linear = Dense(in_dim, num_labels, device=device)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None, train: bool = True):
        logits = self.linear(self.ln(x))
        if not train:
            return logits
        # class ids come as int32 from the loader; the loss takes int64 indices
        return F.cross_entropy(self.scale().to(x.device) * logits, labels.long())


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over every element of ``max(l, 0) - l y + log1p(exp(-|l|))``, in
    fp32: the JAX package's formula as it writes it."""
    logits, labels = logits.float(), labels.float()
    per = torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return per.mean()


@LOSS_HEADS.register()
class BCELossHead(_LogitScale):
    """Multi-label BCE over ``exp(logit_scale) * mlp(x)`` (``mlp``: the
    ``layers`` then ``num_labels``; ``vipant_tpu/nn/losses.py:134-158``);
    eval returns the sigmoid scores."""

    def __init__(self, in_dim: int, num_labels: int, layers: Sequence[int] = (),
                 scaling: bool = True, scale_max: Optional[float] = None, bias: bool = False,
                 device=None):
        super().__init__(scaling, scale_max, device=device)
        self.mlp = _MLPChain(in_dim, [*layers, num_labels], final_bias=bias, device=device)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale().to(x.device) * self.mlp(x)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None, train: bool = True):
        logits = self.logits(x)
        if not train:
            return torch.sigmoid(logits)
        return bce_with_logits(logits, labels)


@LOSS_HEADS.register()
class BCHingeLossHead(BCELossHead):
    """Multi-label margin loss (``vipant_tpu/nn/losses.py:161-188``) over
    ``s = sigmoid(exp(logit_scale) * mlp(x))`` in fp32: per item, the sum
    over (positive j, negative k) of ``max(0, 1 - (s_j - s_k))`` divided by
    the label count; the mean over items. Eval returns ``s``."""

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None, train: bool = True):
        scores = torch.sigmoid(self.logits(x)).float()
        if not train:
            return scores
        pos = labels.bool()
        hinge = torch.clamp(1.0 - (scores[:, :, None] - scores[:, None, :]), min=0.0)
        mask = pos[:, :, None] & ~pos[:, None, :]
        per_item = (hinge * mask).sum(dim=(1, 2)) / scores.shape[-1]
        return per_item.mean()


@LOSS_HEADS.register()
class ImagineAndClassifyLossHead(nn.Module):
    """BCE classification plus ``lambd_ce`` times the "imagination" CE
    (``vipant_tpu/nn/losses.py:345-416``): ``ce`` is a ``CELossHead``
    between ``a2v(audio)`` (an ``_MLPChain`` over ``a2v_layers``; the audio
    embedding itself when there is none) and the image embedding, both
    l2-normalised inside it; ``bce`` the nested ``BCELossHead`` on the raw
    audio embedding. Train returns ``(total, {"ce", "bce"})`` (each term
    whose branch is alive and has its input); eval the BCE head's sigmoid
    scores, which need ``use_bce``."""

    def __init__(self, in_dim: int, num_labels: int, lambd_ce: float = 1.0,
                 a2v_layers: Sequence[int] = (), bias: bool = False, use_ce: bool = True,
                 use_bce: bool = True, scaling: bool = True, scale_max: Optional[float] = None,
                 bce_layers: Sequence[int] = (), bce_scaling: Optional[bool] = None,
                 bce_scale_max: Optional[float] = None, device=None):
        super().__init__()
        self.lambd_ce = float(lambd_ce)
        self.bce = (
            BCELossHead(in_dim, num_labels, layers=bce_layers,
                        scaling=scaling if bce_scaling is None else bce_scaling,
                        scale_max=bce_scale_max, bias=bias, device=device)
            if use_bce else None
        )
        self.a2v = (_MLPChain(in_dim, a2v_layers, final_bias=bias, device=device)
                    if use_ce and len(a2v_layers) > 0 else None)
        self.ce = CELossHead(scaling=scaling, scale_max=scale_max, device=device) if use_ce else None

    def forward(self, audio: torch.Tensor, labels: Optional[torch.Tensor] = None,
                image: Optional[torch.Tensor] = None, train: bool = True
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
        if not train:
            if self.bce is None:
                raise ValueError(
                    "ImagineAndClassifyLossHead eval needs bce.alive=True (multi-label scores); "
                    "for the ce-only imagination branch use the retrieval/zero-shot eval paths")
            return self.bce(audio, labels, train=False)
        total = torch.zeros((), dtype=torch.float32, device=audio.device)
        aux: Dict[str, torch.Tensor] = {}
        if self.ce is not None and image is not None:
            imagined = self.a2v(audio) if self.a2v is not None else audio
            aux["ce"] = self.ce(imagined, image)
            total = total + self.lambd_ce * aux["ce"]
        if self.bce is not None:
            aux["bce"] = self.bce(audio, labels, train=True)
            total = total + aux["bce"]
        return total, aux


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis of [B, C] in fp32: train
    mode normalises by the batch's mean and biased variance (E[x^2] -
    E[x]^2, clipped at 0) and moves the running ``mean`` / ``var`` buffers
    by ``momentum`` (``ra = momentum * ra + (1 - momentum) * batch``); eval
    mode normalises by the running statistics and changes nothing. The
    affine ``weight`` (flax's ``scale``) starts at 1, ``bias`` at 0; the
    running mean at 0, the running variance at 1."""

    data_group = None  # the data mesh whose batch a tower's BatchNorm normalises by

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = float(momentum), float(eps)
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """x: [B, C], or [B, C, H, W] (the ResNet towers: statistics over
        batch and space); the result is fp32 (fp64 for fp64 inputs: flax's
        promotion to at least fp32)."""
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        dims, view = [0, *range(2, x.dim())], (-1,) + (1,) * (x.dim() - 2)
        if train and self.data_group is not None and self.data_group.parallel:
            # the global batch's statistics, as flax takes them under GSPMD: the
            # sums and the sums of squares over every rank's rows, with gradient
            from ..parallel.collectives import all_reduce_sum

            n = x.numel() // x.shape[1] * self.data_group.data
            sums = all_reduce_sum(torch.stack([x.sum(dims), (x * x).sum(dims)]), self.data_group)
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        elif train:
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        if train:
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean.detach())
                self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var.detach())
        else:
            mean, var = self.mean, self.var
        return ((x - mean.view(view)) * (torch.rsqrt(var + self.eps) * self.weight).view(view)
                + self.bias.view(view))


@LOSS_HEADS.register()
class BarlowLossHead(nn.Module):
    """Barlow Twins (``vipant_tpu/nn/losses.py:189-232``; parity:
    `reference/cvap/module/decoder/loss_head.py:286-328`): the projector
    ``dense_0 -> bn_0 -> relu -> ... -> dense_{n-1}`` (bias-free denses
    over ``embed_dim`` then ``layers``) on both inputs, each output
    standardised over the batch (``(z - mean) / (std + 1e-5)``, the biased
    std), ``c = z1^T z2 / B``, and ``sum((diag(c) - 1)^2) + lambd_off *
    (sum(c^2) - sum(diag(c)^2))``. ``normalized`` is accepted for the loss
    heads' common call and ignored."""

    def __init__(self, embed_dim: int, layers: Sequence[int] = (2048, 4096, 4096),
                 lambd_off: float = 0.0051, device=None):
        super().__init__()
        sizes = [int(embed_dim), *[int(v) for v in layers]]
        self.n, self.lambd_off = len(sizes) - 1, float(lambd_off)
        for i in range(self.n):
            self.add_module(f"dense_{i}", Dense(sizes[i], sizes[i + 1], bias=False, device=device))
        for i in range(self.n - 1):
            self.add_module(f"bn_{i}", BatchNorm(sizes[i + 1], device=device))

    def project(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for i in range(self.n - 1):
            x = torch.relu(getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x), train=train))
        return getattr(self, f"dense_{self.n - 1}")(x)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, train: bool = True,
                normalized: bool = False) -> torch.Tensor:
        z1, z2 = self.project(x1, train), self.project(x2, train)

        def std(z):  # jnp's z.std(0): sqrt(mean(|z - mean|^2)), the biased std
            d = z - z.mean(0)
            return d / (torch.sqrt((d * d).mean(0)) + 1e-5)

        c = std(z1).t() @ std(z2) / z1.shape[0]
        diag = torch.diagonal(c)
        on_diag = ((diag - 1.0) ** 2).sum()
        off_diag = (c ** 2).sum() - (diag ** 2).sum()
        return on_diag + self.lambd_off * off_diag


@LOSS_HEADS.register()
class BarlowCELossHead(nn.Module):
    """``ce + lambd_barlow * barlow`` (``vipant_tpu/nn/losses.py:235-258``;
    parity: `reference/cvap/module/decoder/loss_head.py:600-622`): the
    nested ``ce`` (:class:`CELossHead`) and ``barlow``
    (:class:`BarlowLossHead`) heads on the same pair; a scalar, as the JAX
    head returns."""

    def __init__(self, embed_dim: int, lambd_barlow: float = 0.05,
                 barlow_layers: Sequence[int] = (2048, 4096, 4096), lambd_off: float = 0.0051,
                 scaling: bool = True, scale_max: Optional[float] = None, device=None):
        super().__init__()
        self.lambd_barlow = float(lambd_barlow)
        self.ce = CELossHead(scaling=scaling, scale_max=scale_max, device=device)
        self.barlow = BarlowLossHead(embed_dim, barlow_layers, lambd_off, device=device)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, train: bool = True,
                normalized: bool = False) -> torch.Tensor:
        ce = self.ce(x1, x2, normalized=normalized)
        return ce + self.lambd_barlow * self.barlow(x1, x2, train=train)


class _PairwiseCE(nn.Module):
    """Weighted sum of one :class:`CELossHead` a pair (``ce_<pair>``) over
    the pairs that are on and whose inputs are present: ``(total, {pair:
    loss})``."""

    PAIRS: Tuple[str, ...] = ()

    def __init__(self, alive: Dict[str, bool], weights: Dict[str, float], scaling: bool = True,
                 scale_max: Optional[float] = None, device=None):
        super().__init__()
        self.alive = {k: bool(alive[k]) for k in self.PAIRS}
        self.weights = {k: float(weights[k]) for k in self.PAIRS}
        for k in self.PAIRS:
            if self.alive[k]:
                self.add_module(f"ce_{k}", CELossHead(scaling=scaling, scale_max=scale_max,
                                                      device=device))

    def _sum(self, pairs, normalized: bool):
        total = torch.zeros((), dtype=torch.float32)
        aux: Dict[str, torch.Tensor] = {}
        for name, x, y in pairs:
            if self.alive[name] and x is not None and y is not None:
                aux[name] = getattr(self, f"ce_{name}")(x, y, normalized=normalized)
                total = total.to(aux[name].device) + self.weights[name] * aux[name]
        return total, aux


@LOSS_HEADS.register()
class VALCELossHead(_PairwiseCE):
    """Trimodal V-A-L: ``va`` (image, audio), ``lv`` (image, text) and
    ``al`` (audio, text) (``vipant_tpu/nn/losses.py:261-296``; parity:
    `reference/cvap/module/decoder/loss_head.py:421-495`)."""

    PAIRS = ("va", "lv", "al")

    def forward(self, v, a, l, normalized: bool = False):
        return self._sum([("va", v, a), ("lv", v, l), ("al", a, l)], normalized)


@LOSS_HEADS.register()
class VACELossHead(_PairwiseCE):
    """Siamese multi-view VA: ``vp`` (view 1, pivot), ``ap`` (audio 1,
    pivot), ``va`` (view 1, audio 1), ``vv`` (view 1, view 2) and ``aa``
    (audio 1, audio 2) (``vipant_tpu/nn/losses.py:299-342``; parity:
    `reference/cvap/module/decoder/loss_head.py:497-598`)."""

    PAIRS = ("vp", "ap", "va", "vv", "aa")

    def forward(self, v_pivot, v1, a1, v2=None, a2=None, normalized: bool = False):
        return self._sum([("vp", v1, v_pivot), ("ap", a1, v_pivot), ("va", v1, a1),
                          ("vv", v1, v2), ("aa", a1, a2)], normalized)


def build_loss_head(cfg, device=None, in_dim: Optional[int] = None,
                    num_labels: Optional[int] = None) -> nn.Module:
    """Config -> loss head (``vipant_tpu/nn/losses.py:437-523``). The
    classifier heads take the audio embedding's width ``in_dim`` and the
    label count ``num_labels`` (the JAX package's ``output_dim``)."""
    name = cfg.name
    scale_max = cfg.get("scale_max")
    scale_max = None if scale_max is None else float(scale_max)
    if name == "LMLossHead":
        return LMLossHead(scaling=bool(cfg.get("scaling", True)), device=device)
    if name == "CELossHead":
        return CELossHead(scaling=bool(cfg.get("scaling", True)), scale_max=scale_max, device=device)
    if name in ("ClassificationHead", "BCELossHead", "BCHingeLossHead", "ImagineAndClassifyLossHead"):
        if num_labels is None:
            raise ValueError(f"{name} needs the label count (num_labels): the monitor gives it from "
                             "its dataset")
        num_labels = int(num_labels)
    if name == "ClassificationHead":
        return ClassificationHead(in_dim, num_labels, scaling=bool(cfg.get("scaling", True)),
                                  device=device)
    if name in ("BCELossHead", "BCHingeLossHead"):
        return LOSS_HEADS.get(name)(
            in_dim, num_labels, layers=[int(v) for v in cfg.get("layers", []) or []],
            scaling=bool(cfg.get("scaling", True)), bias=bool(cfg.get("bias", False)), device=device)
    if name == "ImagineAndClassifyLossHead":
        ce_max = cfg.ce.get("scale_max")
        bce_max = cfg.bce.get("scale_max")
        return ImagineAndClassifyLossHead(
            in_dim, num_labels, lambd_ce=float(cfg.lambd_ce),
            a2v_layers=[int(v) for v in cfg.get("layers", []) or []],
            bias=bool(cfg.get("bias", False)), use_ce=bool(cfg.ce.get("alive", True)),
            use_bce=bool(cfg.bce.get("alive", True)), scaling=bool(cfg.ce.get("scaling", True)),
            scale_max=None if ce_max is None else float(ce_max),
            bce_layers=[int(v) for v in cfg.bce.get("layers", []) or []],
            bce_scaling=bool(cfg.bce.get("scaling", True)),
            bce_scale_max=None if bce_max is None else float(bce_max), device=device)
    if name == "BarlowLossHead":
        return BarlowLossHead(int(cfg.embed_dim), [int(v) for v in cfg.layers],
                              float(cfg.lambd_off), device=device)
    if name == "BarlowCELossHead":
        ce_max = cfg.ce.get("scale_max")
        return BarlowCELossHead(
            int(cfg.barlow.embed_dim), lambd_barlow=float(cfg.lambd_barlow),
            barlow_layers=[int(v) for v in cfg.barlow.layers],
            lambd_off=float(cfg.barlow.lambd_off), scaling=bool(cfg.ce.get("scaling", True)),
            scale_max=None if ce_max is None else float(ce_max), device=device)
    if name in ("VALCELossHead", "VACELossHead"):
        cls = LOSS_HEADS.get(name)
        # the JAX package's defaults of each flag
        on = {"va": True, "lv": False, "al": True, "vp": True, "ap": False, "vv": True, "aa": False}
        return cls({k: cfg.get(k, on[k]) for k in cls.PAIRS},
                   {k: cfg.get(f"{k}_w", 1.0) for k in cls.PAIRS},
                   scaling=bool(cfg.get("scaling", True)), scale_max=scale_max, device=device)
    raise KeyError(f"unknown loss head {name!r}")
