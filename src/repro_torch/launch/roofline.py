"""Roofline analysis over the dry-run records (twin of
``repro.launch.roofline``).

Per (arch x shape) cell, from the per-device counts of a dry-run record:

  compute_t    = FLOPs_dev / peak_FLOPs          (spec.peak_flops)
  memory_t     = bytes_dev / HBM_bw              (spec.memory.hbm_bw)
  collective_t = wire_bytes_dev / (links x link_bw)  (spec.interconnect)

plus the dominant term, MODEL_FLOPS (6·N·D train / 2·N·D prefill and
decode, N_active for MoE), and the useful-compute ratio MODEL/counted.

Peaks and bandwidths come from the port's device registry
(:mod:`repro_torch.arch`); any registered device rooflines via
``--device``.  **The default device is ``h100``**, a deliberate
difference: the reference defaults to ``tpu_v5e``, the port's target is
the H100.  The bound math is :class:`repro_torch.perf.engines.RooflineEngine`;
``roofline_row`` reads the reference's records and the port's
(:mod:`repro_torch.launch.dryrun`) alike.

    python -m repro_torch.launch.roofline --dryrun-dir DIR [--device h100]
"""

from __future__ import annotations

import argparse
from collections import Counter
from pathlib import Path
from typing import Dict, Optional

from repro_torch.arch import DeviceSpec, get_device
from repro_torch.configs import SHAPES, get_config
from repro_torch.perf.cache import load_artifact
from repro_torch.perf.engines import RooflineEngine
from repro_torch.perf.hlo_ir import KernelGraph
from repro_torch.tree import flatten_with_path

_DEFAULT_DEVICE = "h100"

__all__ = ["roofline_row", "active_fraction", "model_flops", "main",
           "load_cells"]


def active_fraction(arch: str) -> float:
    """Active-parameter fraction for MoE archs (routed experts scaled by
    top_k / n_experts; shared experts and the rest count fully)."""
    cfg = get_config(arch)
    if cfg.moe is None:
        return 1.0
    from repro_torch.perf.torch_graph import meta_params
    total = routed = 0
    for path, leaf in flatten_with_path(meta_params(cfg)):
        n = leaf.numel()
        total += n
        if any(p in ("we_g", "we_i", "we_o") for p in path):
            routed += n
    return (total - routed + routed * cfg.moe.top_k / cfg.moe.n_experts) \
        / total


def model_flops(arch: str, shape_name: str, n_params: int) -> float:
    """6·N·D for training, 2·N·D for single-pass inference (per step)."""
    shape = SHAPES[shape_name]
    n_active = n_params * active_fraction(arch)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # decode: 1 token


def roofline_row(rec: Dict, spec: Optional[DeviceSpec] = None
                 ) -> Optional[Dict]:
    spec = spec or get_device(_DEFAULT_DEVICE)
    hlo = rec.get("hlo", {})
    if "flops_per_device" not in hlo:
        return None
    n_dev = rec["n_devices"]
    f = hlo["flops_per_device"]
    b = hlo["bytes_per_device"]
    graph = KernelGraph.from_totals(
        flops=f, bytes_accessed=b,
        collective_wire=hlo["collective_wire_bytes"],
        # kernel-adjusted: the attention core's intermediates stay on
        # chip in the flash and decode kernels
        flash_block_bytes=hlo.get("flash_block_bytes", 0.0),
        key=f"{rec['arch']}/{rec['shape']}")
    report = RooflineEngine().estimate(graph, spec)
    report_xla = RooflineEngine(kernel_adjusted=False).estimate(graph, spec)
    mf = model_flops(rec["arch"], rec["shape"], rec["n_params"]) / n_dev
    step_t = report.total_time_s
    peak_flops = report.metrics["peak_flops"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_t": report.compute_time_s, "memory_t": report.memory_time_s,
        "memory_t_xla": report_xla.memory_time_s,
        "collective_t": report.collective_time_s, "dominant": report.bound,
        "model_flops_dev": mf, "hlo_flops_dev": f,
        "useful_ratio": mf / f if f else 0.0,
        # useful model FLOPs per second at the bound's step time, vs peak
        "roofline_frac": (mf / step_t) / peak_flops if step_t else 0.0,
        "collectives": hlo.get("collectives", {}),
        "mem_gib": rec.get("memory", {}).get("total_bytes_per_device", 0)
        / 2**30,
        "mem_tpu_est_gib": rec.get("memory", {}).get(
            "tpu_estimate_bytes_per_device", 0) / 2**30,
    }


def load_cells(dryrun_dir: str, mesh: str = "single",
               device: str = _DEFAULT_DEVICE):
    spec = get_device(device)
    rows = []
    for f in sorted(Path(dryrun_dir).glob(f"*_{mesh}.json")):
        row = roofline_row(load_artifact(f), spec)
        if row:
            rows.append(row)
    return rows


def _fmt(rows):
    hdr = (f"| {'arch':24s} | {'shape':11s} | compute_ms | memory_ms | "
           "collective_ms | dominant | MODEL/HLO | roofline |")
    sep = "|" + "-" * 26 + "|" + "-" * 13 + "|" + "-" * 12 + "|" + "-" * 11 \
        + "|" + "-" * 15 + "|" + "-" * 10 + "|" + "-" * 11 + "|" + "-" * 10 + "|"
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r['arch']:24s} | {r['shape']:11s} "
            f"| {r['compute_t'] * 1e3:10.2f} | {r['memory_t'] * 1e3:9.2f} "
            f"| {r['collective_t'] * 1e3:13.2f} | {r['dominant']:8s} "
            f"| {r['useful_ratio']:9.3f} | {r['roofline_frac']:8.3f} |")
    return "\n".join(out)


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="experiments/dryrun")
    ap.add_argument("--out", default="experiments/roofline.md")
    ap.add_argument("--device", default=_DEFAULT_DEVICE,
                    help="device registry name whose peaks/bandwidths "
                         "anchor the roofline (default h100; e.g. "
                         "tpu_v5e, mi300x)")
    args = ap.parse_args(argv)
    rows = load_cells(args.dryrun_dir, device=args.device)
    table = _fmt(rows)
    print(table)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(table + "\n")
    census = Counter(r["dominant"] for r in rows)
    print("\nbottleneck census:", dict(census))


if __name__ == "__main__":
    main()
