"""The output check fails a broken program.

Each test drives a whole run of a cell through the harness on the CPU
at a size the CPU holds (the look for a card skipped: ``device="cpu"``),
with the timed path broken underneath, and sees ``correct`` come out
false; the same run unbroken comes out true.  The faults a serving cell
can have:

* answers altered where they are produced: the engine's greedy choice
  takes the runner-up token;
* a step that returns its state unchanged: the decode step's new K/V
  rows never reach the paged pool;
* half of the batch left out: each decode step computes half of its
  slots (the other half each step) and hands the others the computed
  rows' logits.

A cell on one card has no exchange between chips to leave out.
"""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from h100bench import harness  # noqa: E402
from h100bench.tiny import small  # noqa: E402

def runner_up(monkeypatch):
    from repro_torch.serve import paged_engine
    sample = paged_engine.sample

    def second_best(logits, temperature, gen):
        if temperature > 0:
            return sample(logits, temperature, gen)
        return torch.topk(logits, 2, dim=-1).indices[..., 1]

    monkeypatch.setattr(paged_engine, "sample", second_best)


def state_unchanged(monkeypatch):
    from repro_torch.models import attention
    step = attention.attn_decode_paged

    def no_write(cfg, w, x, cache, tables, lens):
        y, _ = step(cfg, w, x, {k: v.clone() for k, v in cache.items()},
                    tables, lens)
        return y, cache

    monkeypatch.setattr(attention, "attn_decode_paged", no_write)


def half_batch(monkeypatch):
    from repro_torch.serve import paged_engine
    step = paged_engine.paged_decode_step
    calls = [0]

    def half(cfg, params, pools, tokens, tables, lens):
        B = tokens.shape[0]
        keep = torch.arange(B) % 2 == calls[0] % 2
        calls[0] += 1
        out = step(cfg, params, pools, tokens[keep], tables[keep], lens[keep])
        return out.repeat_interleave(2, dim=0)[:B]

    monkeypatch.setattr(paged_engine, "paged_decode_step", half)


CELLS = ["qwen3-moe-8l.chat", "qwen2-7b.longdoc"]


def _run(cell, seed=2**31 + 11):
    return harness.run_cell(cell, seed, 2.0, False, t_start=0.0,
                            device="cpu", overrides=small(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("fault", [runner_up, state_unchanged, half_batch])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    print(cell, fault.__name__, out["compared"])
    assert not out["correct"], out["compared"]
