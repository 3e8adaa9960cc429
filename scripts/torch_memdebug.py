#!/usr/bin/env python
"""Dry-run memory diagnostics with the PyTorch port (twin of
``scripts/memdebug.py``): one production cell's per-device memory and
its largest byte movers.

The reference compiles the cell through XLA and lists the largest
tensors of the compiled per-device module.  The port's dry-run
(:mod:`repro_torch.launch.dryrun`) runs the cell once on meta-device
DTensors over a ``fake`` process group of 256 ranks (the (16, 16)
production mesh), so nothing is allocated and no card is needed.  This
script runs it with a recorder that files every local op's bytes (the
dry-run's counting rules: inputs read and outputs written once) under
its aten op and the model site that issued it: the innermost function
of ``repro_torch.models`` on the Python stack, past the product helpers
(``layers.mm``, ``dense``), else the innermost function of the port
(``train.step._grads`` for the ops of a backward pass).  Ops inside the
plain attention core (``models.attention``'s ``attention``, ``sdpa``,
``_flash_sdpa``) are marked: their intermediates are what the flash and
decode kernels keep on chip, and the roofline subtracts them
(``flash_block_bytes``).

It prints the per-device argument, output and in-place bytes (XLA's
scratch, ``temp``, has no counterpart in an eager run), then the
``--top`` largest (aten op, site) pairs with their share of the total,
then the ``--top`` largest outside the attention core.

    PYTHONPATH=src python scripts/torch_memdebug.py --arch qwen2-7b \\
        --shape prefill_32k [--top 25]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
from collections import Counter
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.launch.dryrun import (_LocalRecorder, fake_world,  # noqa: E402
                                       run_cell)

_PKG = os.sep + "repro_torch" + os.sep
#: Functions of ``repro_torch.models`` that issue ops for their callers.
_HELPERS = {"mm", "_mm", "dense", "_foldable", "_grad_as_output",
            "<lambda>", "forward", "backward", "_apply"}
#: Packages whose frames never name a site (the dry-run's own machinery).
_MACHINERY = ("launch.", "perf.", "parallel.", "kernels.", "tree")


def model_site(frame) -> str:
    """The model site of an op issued below ``frame`` (module docstring)."""
    fallback = None
    while frame is not None:
        path = frame.f_code.co_filename
        if _PKG in path:
            mod = path.split(_PKG, 1)[1][:-len(".py")].replace(os.sep, ".")
            name = frame.f_code.co_name
            if mod.startswith("models.") and name not in _HELPERS:
                return f"{mod}.{name}"
            if fallback is None and not mod.startswith(_MACHINERY):
                fallback = f"{mod}.{name}"
        frame = frame.f_back
    return fallback or "(outside the port)"


class SiteRecorder(_LocalRecorder):
    """The dry-run's recorder, filing each op's bytes under (aten op,
    model site, inside the attention core)."""

    def __init__(self):
        super().__init__()
        self.by_site: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before, core = self.total, self.depth > 0
        out = super().__torch_dispatch__(func, types, args, kwargs)
        moved = self.total - before
        if moved:
            key = (func.overloadpacket.__name__,
                   model_site(sys._getframe(1)), core)
            self.by_site[key] += moved
        return out


def byte_movers(arch: str, shape: str, *, cfg=None, mesh=None
                ) -> Tuple[Dict, Dict[Tuple[str, str, bool], float], float]:
    """Run one dry-run cell (``run_cell``'s arguments) with a
    :class:`SiteRecorder`; returns (the cell's record, bytes by (aten
    op, site, inside the attention core), the recorder's total bytes).
    The default process group must be a ``fake`` one (:func:`fake_world`)
    of the mesh's size."""
    rec_mode = SiteRecorder()
    rec = run_cell(arch, shape, verbose=False, cfg=cfg, mesh=mesh,
                   recorder=rec_mode)
    return rec, dict(rec_mode.by_site), rec_mode.total


def report(rec: Dict, rows: Dict, total: float, top: int) -> List[str]:
    """The printed lines: memory, then the ``top`` largest movers."""
    mem, gib = rec["memory"], 2.0 ** 30
    core = sum(b for (_, _, c), b in rows.items() if c)
    lines = [
        f"{rec['arch']} {rec['shape']} on {rec['mesh']} "
        f"({rec['n_devices']} devices), per device: "
        f"args={mem['argument_size_in_bytes'] / gib:.2f}GiB "
        f"out={mem['output_size_in_bytes'] / gib:.2f}GiB "
        f"alias={mem['alias_size_in_bytes'] / gib:.2f}GiB "
        f"(temp: {mem['not_measured'].split(':')[0]} not measured)",
        f"\n-- largest byte movers by aten op and model site (per device; "
        f"{total / gib:.2f}GiB in all, {core / gib:.2f}GiB inside the "
        "attention core, which the kernels keep on chip) --"]
    ranked = sorted(rows.items(), key=lambda kv: -kv[1])

    def row(key, b):
        op, site, in_core = key
        return (f"{b / gib:8.2f}GiB {100 * b / total:5.1f}%  {op:22s} "
                f"{site}" + ("  [attention core]" if in_core else ""))
    lines += [row(k, b) for k, b in ranked[:top]]
    lines.append(f"\n-- outside the attention core "
                 f"({(total - core) / gib:.2f}GiB) --")
    lines += [row(k, b) for k, b in ranked if not k[2]][:top]
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    with fake_world(256):
        rec, rows, total = byte_movers(args.arch, args.shape)
    print("\n".join(report(rec, rows, total, args.top)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
