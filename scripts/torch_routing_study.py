"""How far deepseek-v2-lite-16b's routing moves under rounding alone, on
one CUDA card: ``chip_smoke.py`` phase 17's check step (its seeds,
weights, prompts and check batch: one decode step of 8 x 512-token
prompts at full width and depth, 26 MoE layers of 64 experts top-6) run
on identical state through the kernel path, the plain path and the
plain path token by token in bf16, and the plain path in float32
(``chip_smoke.f32_routing_readings``).  It prints what phase 17 prints
without holding any limit: each pair's differing (token, layer) routing
pairs, each token's first such layer with its top-6/top-7 margin, and
each bf16 run's logits' distance from float32's.  The margin-only
routing rule the phase held before its float32-arbitrated rule (a
kernel-vs-plain flip's first plain margin below 1e-3) can be read
against the plain path's flips against itself.

    PYTHONPATH=src python3 scripts/torch_routing_study.py --out r.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))
sys.path.append(str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_routing_study: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step
    from repro_torch.serve import ServeEngine
    card = chip_smoke.card_line()
    print(f"card {card}")
    sync = chip_smoke.MLA_SYNC
    cfg = get_config(chip_smoke.MLA["arch"])
    params = chip_smoke.draw_params(torch, cfg, chip_smoke.MLA["seed"],
                                    cfg.name)
    # the same draws as phase 17: its prompts, then its check batch
    rng = np.random.default_rng(sync["seed"])
    for s in sync["prompts"]:
        rng.integers(0, cfg.vocab_size, s)
    batch = rng.integers(0, cfg.vocab_size, sync["check_batch"]
                         ).astype(np.int32)
    logits, cache = ServeEngine(cfg, params, max_len=sync["max_len"],
                                device="cuda").prefill(batch)
    pos = batch.shape[1]
    result = chip_smoke.f32_routing_readings(
        torch, f"{cfg.name} decode step (B={batch.shape[0]}, position {pos})",
        cfg, params, cache, logits.argmax(-1)[:, None],
        lambda c, p, cc, t: decode_step(c, p, cc, t, pos)[0])
    result.pop("logs")
    if args.out:
        Path(args.out).write_text(json.dumps(dict(result, card=card),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
