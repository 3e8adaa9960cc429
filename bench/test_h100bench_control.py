"""The output check's control comes out not correct.

The control is the plain reference computed in float8 (e4m3, one
precision below the configurations' bf16) in the program's place, read
on the same prompts and served tokens: at each position, the float32
reference's gap to the token the float8 one puts first.  On the card
(``cuda``: run with ``python -m pytest -m cuda bench``) each cell runs
at its own sizes and load on three seeds, and the control must exceed
the cell's limit on a compared number while the program stays within
every limit.  On the CPU, at a size a test run holds, the control must
read at least three times the program's mean gap.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from h100bench import calibrate  # noqa: E402
from h100bench.registry import Registry  # noqa: E402
from h100bench.tiny import small  # noqa: E402

CELLS = ["qwen3-moe-8l.chat", "qwen2-7b.longdoc"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program_on_the_cpu(cell):
    recs = list(calibrate.readings(cell, [2**31 + 7], {2**31 + 7}, 2.0,
                                   device="cpu", overrides=small(cell)))
    prog, ctl = recs[0]["program"], recs[0]["control"]
    assert ctl["mean_logit_gap"] >= 3 * prog["mean_logit_gap"]
    assert ctl["mean_logit_gap"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limit_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own sizes")
    reg = Registry()
    limits = reg.workload(cell)["check"]["limits"]
    seconds = reg.benchmark()["run_seconds"]
    seeds = [3900000001, 3900000002, 3900000003]
    for rec in calibrate.readings(cell, seeds, set(seeds), seconds):
        assert rec["correct"], rec
        assert any(rec["control"][k] > v for k, v in limits.items()), rec
