"""The comparison catches a broken timed path: a tiny run on the CPU (the
harness's look for a card skipped) with the port broken underneath comes
out not correct, once for each fault a cell of its kind can have: an answer
altered where it is produced, half of the batch left out, a step that
returns its state unchanged. The sound run, and the control (the reference
one precision step lower in the program's place), come out as they
should."""
from __future__ import annotations

import pytest
import torch
from bench_tiny import run_tiny, tiny_cell
from reference.models import decoder as rdecoder

from benchlib import manifest
from mdqe_cvpr2023_tpu_torch.models import decoder as pdecoder
from mdqe_cvpr2023_tpu_torch.models import meta
from mdqe_cvpr2023_tpu_torch.parallel import train as ptrain


def test_vis_sound_run_is_correct():
    out = run_tiny(tiny_cell("r50_ovis360.vis_crowded"))
    assert out["correct"], out["compared"]


def test_vis_control_is_not_correct():
    out = run_tiny(tiny_cell("r50_ovis360.vis_crowded"), sut="control")
    assert not out["correct"], out["compared"]


def _altered_score(orig):
    def f(*a, **k):
        out = orig(*a, **k)
        out["pred_scores"][0] += 0.05
        return out
    return f


def _altered_mask(orig):
    def f(*a, **k):
        out = orig(*a, **k)
        out["pred_masks"][0] = ~out["pred_masks"][0]
        return out
    return f


def _half_batch(orig):
    def f(detr, frames, sizes, *a, **k):
        # the second half of the encode batch (its frames) left out, the first
        # half's encodings in its place
        half = max(1, frames.shape[0] // 2)
        idx = [i % half for i in range(frames.shape[0])]
        return orig(detr, frames[idx], sizes, *a, **k)
    return f


def _state_unchanged(orig):
    def f(state, *a, **k):
        return state
    return f


@pytest.mark.parametrize("name,fault", [
    ("inference_vis", _altered_score), ("inference_vis", _altered_mask),
    ("encode_window", _half_batch), ("tracker_step", _state_unchanged)])
def test_vis_fault_is_caught(monkeypatch, name, fault):
    monkeypatch.setattr(meta, name, fault(getattr(meta, name)))
    out = run_tiny(tiny_cell("r50_ovis360.vis_crowded"))
    assert not out["correct"], out["compared"]


def test_train_sound_run_is_correct():
    out = run_tiny(tiny_cell("r50_ovis360.train"))
    assert out["correct"], out["compared"]


def _train_half_batch(monkeypatch):
    orig = ptrain.loss_fn

    def f(model, crit_cfg, batch, *a, **k):
        B = batch["valid"].shape[0]
        rows = {n: v.shape[0] // B for n, v in batch.items()}
        half = {n: v[:rows[n] * max(1, B // 2)] for n, v in batch.items()}
        return orig(model, crit_cfg, half, *a, **k)
    monkeypatch.setattr(ptrain, "loss_fn", f)


def _train_state_unchanged(monkeypatch):
    def step(self):
        self.step_count += 1
    monkeypatch.setattr(ptrain._Optimizer, "step", step)


def _train_loss_altered(monkeypatch):
    orig = ptrain.make_train_step

    def make(*a, **k):
        inner = orig(*a, **k)

        def step(*b, **kk):
            total, ld = inner(*b, **kk)
            return total * 1.01, ld
        return step
    monkeypatch.setattr(ptrain, "make_train_step", make)


@pytest.mark.parametrize("fault", [_train_half_batch, _train_state_unchanged,
                                   _train_loss_altered])
def test_train_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_cell("r50_ovis360.train"))
    assert not out["correct"], out["compared"]


def _tie_rel(monkeypatch, cell, tie_rel: float):
    """The training kind with ``TIE_REL`` set to ``tie_rel`` for this test."""
    mod = manifest.kind_module(cell)
    monkeypatch.setattr(mod, "TIE_REL", tie_rel)
    monkeypatch.setattr(manifest, "kind_module", lambda c: mod)


def _nearest_peak_flipped(monkeypatch):
    """The program's first forward takes the runner-up of its nearest-tied
    query peak, as rounding can make it do where two peaks tie."""
    orig = pdecoder.grid_guided_query_selection
    calls = []

    def runner_up(cells):
        sel = cells.argmax(-1)
        rest = cells.scatter(-1, sel[..., None], float("-inf"))
        second = rest.argmax(-1)
        gap = cells.gather(-1, sel[..., None])[..., 0] - rest.gather(-1, second[..., None])[..., 0]
        where = tuple(int(i) for i in torch.unravel_index(gap.argmin(), gap.shape))
        sel = sel.clone()
        sel[where] = second[where]
        return sel

    def f(cfg, rpn_cls_conf):
        calls.append(1)
        if len(calls) > 1:
            return orig(cfg, rpn_cls_conf)
        monkeypatch.setattr(rdecoder, "peak_choice", runner_up)
        try:
            return rdecoder.grid_guided_query_selection(cfg, rpn_cls_conf)
        finally:
            monkeypatch.setattr(rdecoder, "peak_choice", None)
    monkeypatch.setattr(pdecoder, "grid_guided_query_selection", f)


@pytest.mark.parametrize("tie_rel,correct", [(1.0, True), (0.0, False)])
def test_train_near_tied_peak_is_followed(monkeypatch, tie_rel, correct):
    """A program that takes the other side of a near-tied query peak is
    correct where the reference follows its near ties, and a planted flip is
    no rounding where it does not."""
    cell = tiny_cell("r50_ovis360.train")
    _tie_rel(monkeypatch, cell, tie_rel)
    _nearest_peak_flipped(monkeypatch)
    out = run_tiny(cell)
    assert out["correct"] is correct, out["compared"]


def test_train_fault_is_caught_with_near_ties_followed(monkeypatch):
    cell = tiny_cell("r50_ovis360.train")
    _tie_rel(monkeypatch, cell, 1.0)
    _train_half_batch(monkeypatch)
    out = run_tiny(cell)
    assert not out["correct"], out["compared"]


def test_swin_sound_run_is_correct():
    cell = tiny_cell("swinl_ovis.vis")
    out = run_tiny(cell)
    assert out["correct"], out["compared"]
