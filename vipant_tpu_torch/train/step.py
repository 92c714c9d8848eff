"""The training and eval steps on one device.

Counterpart of ``vipant_tpu/train/step.py:make_train_step``: the loss of the
task model on a batch, its grads with respect to the trainable params only,
``grad_norm`` before clipping, then clip and update. A trainable param the
loss does not reach (the captioning decoder's ``text_proj``) gets a zero
grad and the optimizer's update rule all the same, as in the JAX step. Frozen params carry
``requires_grad=False`` and their towers run under ``torch.no_grad()``, so
no backward is built for them (the JAX step keeps them outside the
differentiated function).

:func:`eval_step` is the counterpart of ``make_eval_step``
(``vipant_tpu/train/step.py:175-189``): the model's ``features`` (each
tower's normalised embedding) under ``torch.no_grad()``, on the same
forward kernels as serving.

Under data parallelism (``state.mesh``, :mod:`..parallel`) each rank's loss
is the global batch's (the task models gather the embeddings), and
:func:`..parallel.all_reduce_grads` averages the grads over the data ranks
between the backward and the optimizer, so ``grad_norm``, clipping and
LARS's per-leaf trust ratios act on the global grads. Over the model and
pipe axes each rank's grads are its own slices' and stage's, complete (the
sub-blocks sum their partial products in the forward and backward); over
the seq axis a ringed trunk's grads are summed over the seq group.
:func:`grad_cache_step` is the counterpart of ``make_grad_cache_step``
(``vipant_tpu/train/step.py:97-172``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..parallel.collectives import all_reduce_grads, gather_batch
from ..parallel.grad_cache import grad_cache_value_and_grad
from ..parallel.mesh import seq_partial
from ..utils import span
from .state import TrainState


def loss_aux_and_grads(state: TrainState, *batch
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(loss, its named parts, name -> grad of each trainable param) at the
    current params; nothing is updated. A loss head that returns
    ``(loss, aux)`` (``ImagineAndClassifyLossHead``: ``ce``, ``bce``) gives
    its parts, detached; the others none."""
    with span("vipant.train.forward"):
        out = state.model(*batch, train=True, **state.loss_kwargs)
    loss, aux = out if isinstance(out, tuple) else (out, {})
    names = list(state.trainable)
    with span("vipant.train.backward"):
        grads = torch.autograd.grad(loss, [state.trainable[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(state.trainable[n]) if g is None else g
             for n, g in zip(names, grads)}
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def loss_and_grads(state: TrainState, *batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, name -> grad of each trainable param) at the current params;
    nothing is updated."""
    loss, _, grads = loss_aux_and_grads(state, *batch)
    return loss, grads


def reduce_grads(state: TrainState, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The grads the optimizer takes: ``grads`` averaged over the mesh's data
    ranks (when there is a group), the grads of the trunks split over the
    seq ring summed over its group first."""
    seq_sum = seq_partial(state.model, grads) if state.mesh is not None and state.mesh.seq > 1 else ()
    return all_reduce_grads(grads, state.mesh, seq_sum=seq_sum)


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """:func:`reduce_grads`, then clip and update; advances ``state.step``.
    Returns ``{"grad_norm", "lr"}``."""
    with span("vipant.train.grad_reduce"):
        grads = reduce_grads(state, grads)
    metrics = state.optimizer.apply(grads)
    state.step += 1
    return metrics


def train_step(state: TrainState, *batch) -> Dict[str, object]:
    """One step: ``{"loss", "grad_norm", "lr"}`` and ``loss_<part>`` for
    each named part of the loss (the JAX step's metrics), loss, its parts
    and grad_norm as 0-d device tensors (reading them syncs the host)."""
    loss, aux, grads = loss_aux_and_grads(state, *batch)
    return {"loss": loss, **{f"loss_{k}": v for k, v in aux.items()}, **apply_gradients(state, grads)}


def tower_trains(model: torch.nn.Module, method: str) -> bool:
    """Whether the tower behind ``encode_<tower>`` holds a trainable param."""
    tower = getattr(model, method[len("encode_"):])
    return any(p.requires_grad for p in tower.parameters())


def grad_cache_step(state: TrainState, batch_a: torch.Tensor, batch_b: torch.Tensor,
                    methods: Tuple[str, str], n_chunks: int) -> Dict[str, object]:
    """One gradient-cache step (:mod:`..parallel.grad_cache`): the two
    streams encoded by ``methods`` (e.g. ``("encode_image",
    "encode_audio")``) in ``n_chunks`` chunks each, the model's loss head on
    the whole embedding matrices (gathered over the ranks), the grads
    averaged over the ranks, clip and update. ``{"loss", "grad_norm",
    "lr"}`` as :func:`train_step`."""
    model, mesh = state.model, state.mesh
    enc_a, enc_b = (getattr(model, m) for m in methods)

    def loss_of_embs(ea, eb):
        return model.loss(gather_batch(ea, mesh), gather_batch(eb, mesh), normalized=True)

    with span("vipant.train.grad_cache"):
        loss, grads = grad_cache_value_and_grad(
            lambda x: enc_a(x, train=True), lambda x: enc_b(x, train=True), loss_of_embs,
            state.trainable, batch_a, batch_b, n_chunks, generator=state.generator,
            train_a=tower_trains(model, methods[0]), train_b=tower_trains(model, methods[1]))
    return {"loss": loss, **apply_gradients(state, grads)}


@torch.no_grad()
def eval_step(model: torch.nn.Module, *batch):
    """Each tower's normalised embedding of a batch, without autograd:
    ``(image, audio)`` for CVAP."""
    return model.features(*batch, train=False)
