"""Calibrate the near-tie rule of ``repro_torch.serve.parity``: how far
rounding moves the margins the rule judges, measured on the plain path
against its exact run only (no kernel enters it).

For each workload the plain path (``use_kernels=False``, in the working
type) serves its trace greedily; then the plain path and its exact run
(the plain path one type up: float32 for bf16, float64 for float32,
weights upcast a layer at a time, on an MoE model routed as the plain
path routes) are teacher-forced along those plain streams, and at every
position the script takes

* the shift of the margin between the plain top token and every token
  within ``parity.LOGIT_WINDOW`` of it (``parity.logit_noise``);
* on MoE models, at every routed row, the shift of the probability
  margin between every expert of the plain top-k and every other expert
  within ``parity.ROUTE_WINDOW`` of it in router logit
  (``parity.routing_noise``).

It prints one line per trace and seed and, per working type and family
(dense GQA, MoE, SSM/hybrid, MLA+MoE), the largest shifts, tau = 2x
them and each seed's largest (the spread).  When every family was
measured and their readings lie within 2x of each other's they share
one entry ("all"), else each family has its own: the ``READINGS``
entries to paste into ``parity.py`` are printed last, and the whole
record is written as JSON to ``--out``.  ``--seeds N`` measures each
workload at its own seeds and at its weight and trace seeds + 1000,
2000, ...; ``--dtype`` picks the working types (default both).

Two scales:

* ``--scale reduced`` (the CPU tests' models and traces: every
  family's ``cfg.reduced()``, the ``base`` trace through the sync engine
  and, where the paged engine serves the model, the ``shared_prefix``
  trace through it, with weights drawn from a seed; ~4 min on the CPU
  for both types at three seeds):

      PYTHONPATH=src python scripts/torch_near_tie_calibration.py \\
          --scale reduced --device cpu --seeds 3

* ``--scale full`` (``chip_smoke.py``'s models, cuts, seeds and stream
  traces at full width: in bf16 qwen2-7b phases 3-4, internlm2-20b,
  mistral-nemo-12b and yi-34b phase 16, qwen3-moe phases 8-9, jamba
  phase 14, deepseek phase 17, llama-3.2-vision phase 18, whisper phase
  19; in float32 mamba2-370m phase 12, the one model ``chip_smoke.py``
  holds by the rule in float32; on one H100 ~10 min at three seeds):

      python3 scripts/torch_near_tie_calibration.py --scale full \\
          --seeds 3 --out calibration.json

mamba2-370m's bf16 streams are not held at full width (48 random-weight
SSM layers move its bf16 logits ~30% from float32's; ``chip_smoke.py``
holds them in float32), so only its reduced model enters in bf16.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import (PagedServeEngine, Request,  # noqa: E402
                               ServeEngine, get_trace)
from repro_torch.serve import parity  # noqa: E402

REDUCED = dict(archs=("qwen2-7b", "qwen3-moe-235b-a22b", "mamba2-370m",
                      "jamba-v0.1-52b", "deepseek-v2-lite-16b"),
               base=dict(requests=8, seed=2, max_len=128, n_steps=16),
               shared=dict(requests=8, seed=0, prefix_len=128, max_len=256,
                           page=64, n_steps=16))
# another seed of a workload: its weight and trace seeds plus this
SEED_STRIDE = 1000
FAMILIES = ("dense", "moe", "ssm", "mla_moe")


def measure(label, cfg, plain, reqs, rows, seed):
    t0 = time.perf_counter()
    results, _ = plain.run(reqs)
    top_k = cfg.moe.top_k if cfg.moe is not None else None
    r = parity.noise_readings(plain, parity.exact_engine(plain), reqs,
                              results, top_k=top_k)
    r.update(family=parity.family(cfg), dtype=cfg.dtype, trace=label,
             arch=cfg.name, seed=seed,
             seconds=round(time.perf_counter() - t0, 1))
    print(f"{cfg.name} {cfg.dtype} seed +{seed} {label}: {r['positions']} "
          f"positions, largest logit margin shift {r['logit']:.6g}"
          + ("" if r["route"] is None else
             f", largest routing margin shift {r['route']:.6g}")
          + f" ({r['seconds']} s)", flush=True)
    rows.append(r)


def reduced(device, rows, dtypes, seeds):
    for dtype in dtypes:
        for j in range(seeds):
            for i, arch in enumerate(REDUCED["archs"]):
                reduced_one(device, rows, dtype, j * SEED_STRIDE, i, arch)


def reduced_one(device, rows, dtype, off, i, arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                              use_kernels=False)
    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(i + off), device=device)
    b = REDUCED["base"]
    reqs = get_trace("base")(b["requests"], cfg.vocab_size,
                             seed=b["seed"] + off, max_len=b["max_len"])
    for r in reqs:
        r.n_steps = b["n_steps"]
    plain = ServeEngine(cfg, params, max_len=b["max_len"], device=device)
    measure("base trace, sync engine", cfg, plain, reqs, rows, off)
    if cfg.ssm is not None or cfg.mla is not None:
        return                            # the paged pool takes neither
    s = REDUCED["shared"]
    reqs = get_trace("shared_prefix")(s["requests"], cfg.vocab_size,
                                      seed=s["seed"] + off,
                                      prefix_len=s["prefix_len"])
    for r in reqs:
        r.n_steps = s["n_steps"]
    plain = PagedServeEngine(cfg, params, max_len=s["max_len"],
                             max_batch=s["requests"], page=s["page"],
                             device=device)
    measure("shared-prefix trace, paged engine", cfg, plain, reqs, rows, off)


def full(rows, dtypes, seeds):
    import chip_smoke as cs
    from repro_torch.models.blocks import layer_sigs

    def sync_reqs(cfg, run, off):
        rng = np.random.default_rng(run["seed"] + off)
        return [Request(prompt=rng.integers(0, cfg.vocab_size, s)
                        .astype(np.int32), n_steps=run["n_steps"])
                for s in run["prompts"]]

    def sync(label, cfg, params, run, off):
        plain = ServeEngine(cfg, params, max_len=run["max_len"],
                            device="cuda")
        measure(label, cfg, plain, sync_reqs(cfg, run, off), rows, off)

    def paged(label, cfg, params, off):
        plain = cs.new_engine(cfg, params)
        reqs = cs.serve_trace(cfg.vocab_size, seed=cs.SERVE["seed"] + off)
        measure(label, cfg, plain, reqs, rows, off)

    def loop(label, cfg, params, extras, run, off):
        plain = cs.ModelLoop(cfg, params, extras, run["max_len"])
        measure(label, cfg, plain, sync_reqs(cfg, run, off), rows, off)

    def model(arch, seed, off, n_layers=None, dtype="bfloat16"):
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, use_kernels=False)
        params = cs.draw_params(torch, cfg, seed + off, cfg.name)
        if dtype == "float32":
            # drawn in bf16 and upcast, as chip_smoke.py's float32 phases
            # hold them
            cfg = dataclasses.replace(cfg, dtype="float32")
            params = parity.float32_params(params)
        return cfg, params

    def free():
        torch.cuda.empty_cache()

    for j in range(seeds):
        off = j * SEED_STRIDE
        if "bfloat16" in dtypes:
            full_bf16(cs, layer_sigs, model, paged, sync, loop, free, off)
        if "float32" in dtypes:
            cfg, p = model(cs.SSM["arch"], cs.SSM["seed"], off,
                           dtype="float32")
            sync("phase 12 prompts, sync engine", cfg, p, cs.SSM_SYNC, off)
            del p
            free()


def full_bf16(cs, layer_sigs, model, paged, sync, loop, free, off):
    cfg, p = model(cs.SERVE["arch"], cs.SERVE["seed"], off)
    paged("phase 3 shared-prefix trace, paged engine", cfg, p, off)
    sync("phase 4 prompts, sync engine", cfg, p, cs.SYNC, off)
    del p
    free()
    for i, arch in enumerate(cs.DENSE["archs"]):
        cfg, p = model(arch, cs.DENSE["seed"] + i, off, cs.DENSE["n_layers"])
        paged("phase 16 shared-prefix trace, paged engine", cfg, p, off)
        sync("phase 16 prompts, sync engine", cfg, p, cs.DENSE_SYNC, off)
        del p
        free()
    cfg, p = model(cs.MOE["arch"], cs.MOE["seed"], off, cs.MOE["n_layers"])
    paged("phase 8 shared-prefix trace, paged engine", cfg, p, off)
    sync("phase 9 prompts, sync engine", cfg, p, cs.MOE_SYNC, off)
    del p
    free()
    cfg, p = model(cs.HYBRID["arch"], cs.HYBRID["seed"], off,
                   cs.HYBRID["n_layers"])
    sync("phase 14 prompts, sync engine", cfg, p, cs.HYBRID_SYNC, off)
    del p
    free()
    cfg, p = model(cs.MLA["arch"], cs.MLA["seed"], off)
    sync("phase 17 prompts, sync engine", cfg, p, cs.MLA_SYNC, off)
    del p
    free()
    cfg, p = model(cs.VLM["arch"], cs.VLM["seed"], off, cs.VLM["n_layers"])
    g = torch.Generator(device="cuda").manual_seed(cs.VLM["seed"] + 100 + off)
    for i, s in enumerate(layer_sigs(cfg)):
        if s[0] == "cross":
            p["layers"][i]["gate"] = torch.rand(
                (), generator=g, device="cuda") * 0.5 + 0.25
    media = torch.randn((1, cfg.cross_attn.n_media_tokens, cfg.d_model),
                        generator=g, device="cuda").to(torch.bfloat16)
    loop("phase 18 prompts, prefill + decode_step", cfg, p,
         {"media": media}, cs.VLM_RUN, off)
    del p, media
    free()
    cfg, p = model(cs.ENC["arch"], cs.ENC["seed"], off)
    g = torch.Generator(device="cuda").manual_seed(cs.ENC["seed"] + 100 + off)
    frames = torch.randn((1, cfg.encoder.n_frames, cfg.d_model),
                         generator=g, device="cuda").to(torch.bfloat16)
    loop("phase 19 prompts, prefill + decode_step", cfg, p,
         {"frames": frames}, cs.ENC_RUN, off)
    del p, frames
    free()


def summarise(rows):
    """Per family the largest shifts over every trace and seed, with
    the spread of each seed's largest shift (``"by_seed"``), and the
    entries of ``READINGS``: one "all" entry when every family was
    measured and their readings lie within 2x of each other's (logits;
    routing over the MoE families), else one a measured family."""
    fams = {}
    for r in rows:
        f = fams.setdefault(r["family"], {"logit": 0.0, "route": None,
                                          "by_seed": {}})
        f["logit"] = max(f["logit"], r["logit"])
        s = f["by_seed"].setdefault(r["seed"], [0.0, None])
        s[0] = max(s[0], r["logit"])
        if r["route"] is not None:
            f["route"] = max(f["route"] or 0.0, r["route"])
            s[1] = max(s[1] or 0.0, r["route"])
    logits = [f["logit"] for f in fams.values()]
    routes = [f["route"] for f in fams.values() if f["route"] is not None]
    if len(fams) == len(FAMILIES) and max(logits) <= 2 * min(logits) and (
            not routes or max(routes) <= 2 * min(routes)):
        return fams, {"all": (max(logits), max(routes, default=None))}
    return fams, {n: (f["logit"], f["route"]) for n, f in fams.items()}


def up(x: float) -> float:
    """``x`` rounded up to four significant digits (a reading is a
    lower bound of the noise, so it is never rounded down)."""
    if x == 0:
        return 0.0
    q = 10.0 ** (math.floor(math.log10(abs(x))) - 3)
    return float(f"{math.ceil(x / q) * q:.4g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", choices=("reduced", "full"), required=True)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    action="append", help="working types to measure "
                    "(repeatable; default both)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds of each workload: its own, then its "
                    f"weight and trace seeds + {SEED_STRIDE} x 1, 2, ...")
    ap.add_argument("--device", default="cuda",
                    help="reduced scale only (full runs on the card)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    dtypes = args.dtype or ["bfloat16", "float32"]
    t0 = time.perf_counter()
    rows = []
    if args.scale == "reduced":
        reduced(torch.device(args.device), rows, dtypes, args.seeds)
    else:
        if not torch.cuda.is_available():
            print("--scale full needs a GPU", file=sys.stderr)
            return 1
        full(rows, dtypes, args.seeds)
    device = (torch.cuda.get_device_name(0) if args.scale == "full"
              else "CPU")
    record = {"scale": args.scale, "device": device, "rows": rows,
              "by_dtype": {}, "seconds": None}
    for dtype in dtypes:
        fams, entries = summarise([r for r in rows if r["dtype"] == dtype])
        record["by_dtype"][dtype] = {"families": fams, "readings": entries}
        for name, f in sorted(fams.items()):
            route = "" if f["route"] is None else (
                f", routing {f['route']:.6g} (tau {2 * f['route']:.6g})")
            spread = "; by seed " + ", ".join(
                f"+{k}: {v[0]:.4g}" + ("" if v[1] is None else f"/{v[1]:.4g}")
                for k, v in sorted(f["by_seed"].items()))
            print(f"{dtype} family {name}: logits {f['logit']:.6g} (tau "
                  f"{2 * f['logit']:.6g}){route}{spread}")
        print(f"READINGS[{dtype!r}][{args.scale!r}] = " + json.dumps(
            {k: [up(v[0]), None if v[1] is None else up(v[1])]
             for k, v in entries.items()}))
    record["seconds"] = round(time.perf_counter() - t0, 1)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(f"elapsed {record['seconds']} s on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
