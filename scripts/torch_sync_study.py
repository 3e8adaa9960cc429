"""Two studies of the port's sync serve engine on full-width qwen2-7b on
one CUDA card, made to compare two versions of its attention kernels: run
the script once with each version's ``src`` first on ``PYTHONPATH`` (it
falls back to this checkout's ``src``).  The weights are random bf16,
drawn from ``chip_smoke.py``'s seed, so both runs serve the same model.

``--timing``: wall time of the engine's calls, each ending in a
synchronize (the way ``chip_smoke.py`` profiles them), as the median and
range over repeated calls: a B = 4 decode step at position 1024 (the
``generate`` batch), a B = 1 decode step at position 2000 (the
``run(batch=1)`` step) and a 2048-row prefill.

``--agreement N``: N prompts of 500 to 2000 tokens drawn from a seed,
each fed through the kernel path, the plain path and the plain path in
float32 (weights upcast), teacher-forced along the plain path's greedy
stream of ``--steps`` tokens.  At each position it records the three
argmaxes, the top-2 margins and the relative distances of the logits,
and it prints how often the kernel path's token differs from the plain
path's, at what plain margin, and which of the two the float32 path
picks there.

    PYTHONPATH=src python3 scripts/torch_sync_study.py --timing \\
        --agreement 32 --out study.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))
sys.path.append(str(ROOT / "src"))

import chip_smoke  # noqa: E402


def spread(xs):
    """Median, 10th and 90th percentile, min and max of ``xs``, in ms."""
    xs = sorted(xs)
    pick = lambda f: xs[min(len(xs) - 1, int(f * len(xs)))]   # noqa: E731
    return {"median": statistics.median(xs), "p10": pick(0.1),
            "p90": pick(0.9), "min": xs[0], "max": xs[-1], "n": len(xs)}


def wall_ms(torch, fn, n: int):
    """Wall time of each of ``n`` calls of ``fn`` (after two warm-up
    calls), each ending in a synchronize."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return spread(out)


def timing(torch, cfg, params, reps: int):
    import numpy as np
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, max_len=2048, device="cuda")
    rng = np.random.default_rng(7)
    out = {}
    for B, pos in ((4, 1024), (1, 2000)):
        toks = rng.integers(0, cfg.vocab_size, (B, pos)).astype(np.int32)
        logits, cache = eng.prefill(toks)
        tok = logits.argmax(-1)[:, None]
        out[f"decode B={B} position {pos}"] = wall_ms(
            torch, lambda: eng.decode(cache, tok, pos).argmax(-1).cpu(), reps)
        del cache
    prompt = rng.integers(0, cfg.vocab_size, (1, 2048)).astype(np.int32)
    out["prefill 2048 rows"] = wall_ms(
        torch, lambda: eng.prefill(prompt)[0].argmax(-1).cpu(),
        max(5, reps // 5))
    for k, v in out.items():
        print(f"{k}: wall median {v['median']:.3f} ms (p10 {v['p10']:.3f}, "
              f"p90 {v['p90']:.3f}, min {v['min']:.3f}, max {v['max']:.3f}; "
              f"{v['n']} calls)")
    return out


# the margin-only near-tie rule this study was first run against: a
# plain top-2 margin below it (repro_torch.serve.parity now asks the
# float32 run instead)
MARGIN_RULE = 0.05


def agreement(torch, cfg, params, n_prompts: int, n_steps: int):
    import numpy as np
    from repro_torch.serve import Request, ServeEngine
    kern = ServeEngine(cfg, params, max_len=2048, device="cuda")
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    plain = ServeEngine(plain_cfg, params, max_len=2048, device="cuda")
    f32 = ServeEngine(dataclasses.replace(plain_cfg, dtype="float32"),
                      chip_smoke._map(lambda t: t.float(), params),
                      max_len=2048, device="cuda")
    rng = np.random.default_rng(11)
    lens = rng.integers(500, 2001, n_prompts)
    rows = []
    for i, s in enumerate(lens):
        prompt = rng.integers(0, cfg.vocab_size, int(s)).astype(np.int32)
        res, _ = plain.run([Request(prompt=prompt, n_steps=n_steps)])
        stream = [int(t) for t in res[0].tokens]
        got = [e.teacher_forced_logits(prompt, stream)
               for e in (kern, plain, f32)]
        for t, (lk, lp, lf) in enumerate(zip(*got)):
            lk, lp, lf = lk.float(), lp.float(), lf.float()
            top = {n: torch.topk(x, 2) for n, x in
                   (("kernel", lk), ("plain", lp), ("f32", lf))}
            rows.append({
                "prompt": i, "len": int(s), "step": t,
                **{f"{n}_token": int(v.indices[0]) for n, v in top.items()},
                **{f"{n}_margin": float(v.values[0] - v.values[1])
                   for n, v in top.items()},
                "kernel_vs_plain": float((lk - lp).norm() / lp.norm()),
                "kernel_vs_f32": float((lk - lf).norm() / lf.norm()),
                "plain_vs_f32": float((lp - lf).norm() / lf.norm())})
    flips = [r for r in rows if r["kernel_token"] != r["plain_token"]]
    above = [r for r in flips if r["plain_margin"] >= MARGIN_RULE]
    mean = lambda k: statistics.fmean(r[k] for r in rows)   # noqa: E731
    summary = {
        "positions": len(rows), "kernel_differs_from_plain": len(flips),
        "at_plain_margin_above_near_tie": len(above),
        "flip_plain_margins": sorted(r["plain_margin"] for r in flips),
        "f32_picks_kernel_token_at_flips": sum(
            r["f32_token"] == r["kernel_token"] for r in flips),
        "f32_picks_plain_token_at_flips": sum(
            r["f32_token"] == r["plain_token"] for r in flips),
        "kernel_differs_from_f32": sum(
            r["kernel_token"] != r["f32_token"] for r in rows),
        "plain_differs_from_f32": sum(
            r["plain_token"] != r["f32_token"] for r in rows),
        "mean_kernel_vs_plain": mean("kernel_vs_plain"),
        "mean_kernel_vs_f32": mean("kernel_vs_f32"),
        "mean_plain_vs_f32": mean("plain_vs_f32")}
    print(f"agreement over {n_prompts} prompts x {n_steps} positions: "
          + json.dumps(summary))
    del kern, plain, f32
    torch.cuda.empty_cache()
    return summary, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--agreement", type=int, default=0, metavar="N")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_sync_study: needs a CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.configs import get_config
    cfg = get_config(chip_smoke.SERVE["arch"])
    print(f"card: {chip_smoke.card_line()}; repro_torch from "
          f"{Path(repro_torch.__file__).parent}")
    params = chip_smoke.draw_params(torch, cfg, chip_smoke.SERVE["seed"],
                                    f"{cfg.name} full width")
    result = {"card": chip_smoke.card_line(),
              "src": str(Path(repro_torch.__file__).parent)}
    if args.timing:
        result["timing"] = timing(torch, cfg, params, args.reps)
    if args.agreement:
        result["agreement"], result["positions"] = agreement(
            torch, cfg, params, args.agreement, args.steps)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
