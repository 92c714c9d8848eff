"""The check fails what it must: the control (the precision below the
configuration's) and each fault a cell can have, planted under a run whose
look for a card is skipped."""

import json

import numpy as np
import pytest
import torch

from perfbench import control, run
from perfbench.drivers import common
from perfbench.harness import spec
from perfbench.tests.tiny import patch

SEED = 2_147_483_999
CONTROL = {"va_pretrain_b432": "fp8", "clap_finetune_b50": "fp8", "clap_embed_audio_b64": "int8"}


def _run(capsys, name):
    """A tiny run in float32, where a sound program reads the reference's
    numbers to rounding: what fails is the fault."""
    rc = run.main(["--workload", name, "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                  device="cpu", patch=patch(fp32=True))
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["va_pretrain_b432", "clap_finetune_b50"])
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(capsys, monkeypatch, name):
    from vipant_tpu_torch.optim import build

    def unchanged(self, grads):
        self.count += 1
        return {"grad_norm": torch.zeros(()), "lr": 0.0}

    monkeypatch.setattr(build.Optimizer, "apply", unchanged)
    line = _run(capsys, name)
    assert line["correct"] is False and line["check"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["va_pretrain_b432", "clap_finetune_b50"])
def test_a_loss_over_half_the_batch_is_not_correct(capsys, monkeypatch, name):
    from vipant_tpu_torch.nn import losses

    whole = losses.CELossHead.forward

    def half(self, x1, x2, normalized=False):
        n = x1.shape[0] // 2
        return whole(self, x1[:n], x2[:n], normalized)

    monkeypatch.setattr(losses.CELossHead, "forward", half)
    line = _run(capsys, name)
    assert line["correct"] is False and line["check"]["loss_gap"]["value"] > line["check"]["loss_gap"]["limit"]


@pytest.mark.parametrize("name", ["va_pretrain_b432", "clap_finetune_b50"])
def test_a_gradient_handed_to_another_leaf_is_not_correct(capsys, monkeypatch, name):
    """Two blocks' MLP weights get each other's gradient: LARS's trust ratio
    hides it from the weights' updates, the gradient's norm does not."""
    from vipant_tpu_torch.optim import build

    apply = build.Optimizer.apply

    def misrouted(self, grads):
        a, b = [n for n in grads if n.endswith("mlp.c_fc.weight")][:2]
        return apply(self, {**grads, a: grads[b], b: grads[a]})

    monkeypatch.setattr(build.Optimizer, "apply", misrouted)
    line = _run(capsys, name)
    assert line["correct"] is False and line["check"]["grad_gap"]["value"] > line["check"]["grad_gap"]["limit"]
    assert line["check"]["state_gap"]["value"] < line["check"]["state_gap"]["limit"]


def test_an_answer_altered_where_it_is_made_is_not_correct(capsys, monkeypatch):
    from vipant_tpu_torch.serve import InferenceEngine

    made = InferenceEngine._run_batched

    def altered(self, method, arr):
        out = made(self, method, arr)
        out[-1] = out[0]  # one row answers another item's input
        return out

    monkeypatch.setattr(InferenceEngine, "_run_batched", altered)
    line = _run(capsys, "clap_embed_audio_b64")
    assert line["correct"] is False


@pytest.mark.parametrize("name", sorted(CONTROL))
def test_the_control_is_not_correct(name):
    cell = spec.cell(name)
    patch()(cell)
    numbers = control.readings(cell, CONTROL[name], SEED, "cpu")
    assert not common.passed(common.judge(numbers, cell["limits"])), numbers


def test_the_half_batch_fault_in_the_reference_is_not_correct():
    cell = spec.cell("va_pretrain_b432")
    patch()(cell)
    numbers = control.readings(cell, "half", SEED, "cpu")
    assert not common.passed(common.judge(numbers, cell["limits"])), numbers


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONTROL))
def test_the_control_is_not_correct_at_the_cells_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    cell = spec.cell(name)
    for seed in (101, 202, 303):
        numbers = control.readings(cell, CONTROL[name], seed, "cuda:0")
        assert not common.passed(common.judge(numbers, cell["limits"])), (seed, numbers)
        assert all(np.isfinite(v) for v in numbers.values())
