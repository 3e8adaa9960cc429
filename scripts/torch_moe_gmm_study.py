"""How the port's ``moe_gmm`` kernel rounds, and what that does to MoE
routing, on one CUDA card: run the script once with each version's
``src`` first on ``PYTHONPATH`` (it falls back to this checkout's
``src``) to compare two versions of the kernel.

1. ``moe_gmm`` at the expert shapes of the serving paths (qwen3-moe's
   and jamba's decode and prefill products, random bf16 operands from a
   seed): the share of its outputs equal to the plain version's (an f32
   GEMM rounded once to bf16), and the share of each equal to the exact
   sum (float64) rounded once.
2. ``chip_smoke.py``'s phase-14 routing check: jamba-v0.1-52b at full
   width cut to one 8-layer period (its seeds, weights and prompts), one
   decode step of 8 x 512-token prompts through the kernel and the plain
   path on identical state, printing every (layer, token) whose top-2
   expert set differs with the plain path's top-2/top-3 probability
   margin there.  The margin-only rule this study was run against
   failed where a token's first such margin was at least 1e-3 (the
   phase now asks the float32 run); here nothing fails.

    PYTHONPATH=src python3 scripts/torch_moe_gmm_study.py --out moe.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))
sys.path.append(str(ROOT / "src"))

import chip_smoke  # noqa: E402

# (E, C, K, N): qwen3-moe's decode gate/up and down (8 slots x 4) and its
# 2000-row prefill gate/up; jamba's decode (8 slots x 4) and a 640-row
# prefill (8 x 512 prompts), gate/up and down
SHAPES = {
    "qwen3-moe decode gate/up": (128, 32, 4096, 1536),
    "qwen3-moe decode down": (128, 32, 1536, 4096),
    "qwen3-moe prefill gate/up": (128, 160, 4096, 1536),
    "jamba decode gate/up": (16, 32, 4096, 14336),
    "jamba decode down": (16, 32, 14336, 4096),
    "jamba prefill gate/up": (16, 640, 4096, 14336),
    "jamba prefill down": (16, 640, 14336, 4096),
}


def roundings(torch):
    """Part 1: shares of equal outputs at each of ``SHAPES``."""
    from repro_torch.kernels import moe_gmm, moe_gmm_plain
    g = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for label, (E, C, K, N) in SHAPES.items():
        x = torch.randn((E, C, K), generator=g, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((E, K, N), generator=g, device="cuda")
             / math.sqrt(K)).to(torch.bfloat16)
        got, plain = moe_gmm(x, w), moe_gmm_plain(x, w)
        exact = torch.bmm(x.double(), w.double()).to(torch.bfloat16)
        out[label] = {
            "kernel_equal_plain": float((got == plain).float().mean()),
            "kernel_equal_exact": float((got == exact).float().mean()),
            "plain_equal_exact": float((plain == exact).float().mean())}
        print(f"{label} (E={E} C={C} K={K} N={N}): {json.dumps(out[label])}")
        del x, w, got, plain, exact
    torch.cuda.empty_cache()
    return out


def routing(torch):
    """Part 2: every routing difference of phase 14's decode step."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.parity import routing_differences, routing_log
    sync = chip_smoke.HYBRID_SYNC
    cfg = dataclasses.replace(get_config(chip_smoke.HYBRID["arch"]),
                              n_layers=chip_smoke.HYBRID["n_layers"])
    params = chip_smoke.draw_params(torch, cfg, chip_smoke.HYBRID["seed"],
                                    f"{cfg.name}, one period")
    eng = ServeEngine(cfg, params, max_len=sync["max_len"], device="cuda")
    eng.generate(np.arange(16, dtype=np.int32)[None], n_steps=2)
    # the same draws as phase 14: its prompts, then its check batch
    rng = np.random.default_rng(sync["seed"])
    eng.run([Request(prompt=rng.integers(0, cfg.vocab_size, s)
                     .astype(np.int32), n_steps=sync["n_steps"])
             for s in sync["prompts"]])
    batch = rng.integers(0, cfg.vocab_size, sync["check_batch"]
                         ).astype(np.int32)
    logits, cache = eng.prefill(batch)
    tok = logits.argmax(-1)[:, None]
    logs = {}
    for name, c in (("kernel", cfg),
                    ("plain", dataclasses.replace(cfg, use_kernels=False))):
        state = chip_smoke._map(lambda t: t.clone(), cache)
        with routing_log() as log:
            decode_step(c, params, state, tok, batch.shape[1])
        logs[name] = log
    flips = [{"layer": layer, "token": r, "plain_margin": m}
             for layer, diff in routing_differences(
                 cfg.moe.top_k, logs["kernel"], logs["plain"])
             for r, m in diff]
    for f in flips:
        print(f"routing differs at layer {f['layer']}, token {f['token']}: "
              f"plain top-2/top-3 margin {f['plain_margin']:.6f}")
    if not flips:
        print("routing: every top-2 set identical on the two paths")
    return flips


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_gmm_study: needs a CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    print(f"repro_torch from {Path(repro_torch.__file__).parent}; card "
          f"{chip_smoke.card_line()}")
    result = {"card": chip_smoke.card_line(), "roundings": roundings(torch),
              "routing_flips": routing(torch)}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
