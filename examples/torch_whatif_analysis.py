"""MCE what-if analysis over the port's own models (paper Section V-B,
beyond the microbenchmarks): sweep --mfma-scale over a model's training
step through the unified ``repro_torch.perf`` pipeline — every device in
the ``repro_torch.arch`` registry, a composed overlay-grid scenario
sweep (MFMA x clock), and all three cost engines (roofline / analytic
MFMA / event-driven scoreboard) answering from the same KernelGraph.
The twin of ``examples/whatif_analysis.py``: where that one lowers the
JAX model through XLA and parses the HLO, this one captures the PyTorch
model's aten ops on the meta device (``repro_torch.perf.torch_graph``),
so even ``--full`` widths cost no memory and need no GPU.

The H100 has no MFMA cycle table: only the roofline engine prices it,
and its rows say so.

    PYTHONPATH=src python examples/torch_whatif_analysis.py \\
        --arch qwen2-7b [--full] [--devices mi300,mi300x,h100] \\
        [--grid-device mi300x]
"""

import argparse
import dataclasses
import sys
from typing import List, Optional

import torch

from repro_torch.arch import Overlay, list_devices, overlay_grid
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.machine import get_machine
from repro_torch.models import loss_fn
from repro_torch.perf import format_reports, predict, sweep
from repro_torch.perf.torch_graph import capture, meta_params, meta_tokens

BATCH = (2, 64)       # tokens of the training step, as the JAX example


def _has_matrix_model(device: str) -> bool:
    m = get_machine(device)
    return bool(m.mxu_count) or m.has_mfma_table


def train_graph(arch: str, *, full: bool = False):
    """The plain-path training step's graph (forward and loss) of
    ``arch``, reduced unless ``full``, captured on the meta device."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg if full else cfg.reduced(),
                              use_kernels=False)
    batch = {"tokens": meta_tokens(BATCH), "labels": meta_tokens(BATCH)}
    if cfg.cross_attn:
        batch["media"] = torch.empty(
            (BATCH[0], cfg.cross_attn.n_media_tokens, cfg.d_model),
            dtype=torch.bfloat16, device="meta")
    if cfg.encoder:
        batch["frames"] = torch.empty(
            (BATCH[0], cfg.encoder.n_frames, cfg.d_model),
            dtype=torch.bfloat16, device="meta")
    return cfg, capture(loss_fn, cfg, meta_params(cfg), batch)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: the "
                         "reduced config)")
    ap.add_argument("--scales", default="0.5,1,2,4")
    ap.add_argument("--devices", default=None,
                    help="comma-separated registry names "
                         "(default: every registered device)")
    ap.add_argument("--grid-device", default="mi300x",
                    help="device for the composed overlay-grid sweep")
    args = ap.parse_args(argv)

    scales = [float(s) for s in args.scales.split(",")]
    devices = ([d.strip() for d in args.devices.split(",") if d.strip()]
               if args.devices else list(list_devices()))
    unknown = [d for d in devices + [args.grid_device]
               if d not in list_devices()]
    if unknown:
        ap.error(f"unknown device(s) {unknown}; "
                 f"registered: {list(list_devices())}")
    if not _has_matrix_model(args.grid_device):
        ap.error(f"--grid-device {args.grid_device} has no MFMA cycle table "
                 "or MXUs: the mfma engine cannot price it")

    cfg, graph = train_graph(args.arch, full=args.full)
    print(f"{cfg.name} ({'full' if args.full else 'reduced'}) train step: "
          f"{graph.flops / 1e9:.2f} GFLOP, {len(graph.dots)} dot sites")

    print(f"\n{'machine':10s} " + " ".join(f"x{s:<8g}" for s in scales)
          + "  (matrix-unit-bound us)")
    for name in devices:
        if not _has_matrix_model(name):
            rep = predict(graph, device=name, engine="roofline")
            print(f"{name:10s} roofline only: {rep.total_time_s * 1e6:.1f} "
                  f"us ({rep.bound}-bound; no MFMA cycle table)")
            continue
        reports = predict(graph, device=name, engine="mfma",
                          overlays=[Overlay(mfma_scale=s) for s in scales])
        print(f"{name:10s} " + " ".join(
            f"{r.total_time_s * 1e6:<9.1f}" for r in reports))

    print(f"\noverlay grid on {args.grid_device} "
          "(scenario: matrix-unit-bound us)")
    for r in predict(graph, device=args.grid_device, engine="mfma",
                     overlays=overlay_grid(mfma_scale=(0.5, 1.0, 2.0),
                                           clock_scale=(1.0, 1.2))):
        print(f"  {r.scenario:24s} {r.total_time_s * 1e6:.1f}")

    print("\nengine comparison (same KernelGraph, baseline scenario)")
    reports = sweep({args.arch: graph}, devices=[args.grid_device],
                    engines=("roofline", "mfma", "scoreboard"))
    reports += [predict(graph, device=d, engine="roofline",
                        workload_name=args.arch)
                for d in devices if not _has_matrix_model(d)]
    print(format_reports(reports))
    print("\nNOTE (paper Section VI): on real code the end-to-end speedup "
          "is sub-linear in mfma-scale — compiler-scheduled independent "
          "work between MFMAs is fixed at compile time.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
