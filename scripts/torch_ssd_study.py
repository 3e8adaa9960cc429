"""How the port's ``mamba2_ssd`` kernels round, and what that does to the
hybrid model's checks, on one CUDA card: run the script once with each
version's ``src`` first on ``PYTHONPATH`` (it falls back to this
checkout's ``src``) to compare two versions of the kernels.

1. ``mamba2_ssd`` at ``chip_smoke.py``'s phase-11 shapes (mamba2's and
   jamba's prefills, the same seed and inputs): the share of the bf16 y
   equal to the plain version's, and the share of each equal to the
   exact y (a float64 step-by-step recurrence) rounded once to bf16;
   the largest y and state differences from the plain version.
2. ``chip_smoke.py``'s phase 14 as it stands: jamba-v0.1-52b at full
   width cut to one 8-layer period through the sync engine (its seeds,
   weights and prompts), with the decode step's routing differences and
   the greedy streams' first divergences printed with their plain-path
   margins.  The phase fails where its float32-arbitrated near-tie
   rule (``repro_torch.serve.parity``) refuses a routing difference or
   a stream's first divergence; here the failure is printed, not
   raised.

    PYTHONPATH=src python3 scripts/torch_ssd_study.py --out ssd.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))
sys.path.append(str(ROOT / "src"))

import chip_smoke  # noqa: E402

# (S, nh, ds) at head dim 64, one B/C group: chip_smoke's phase-11 cases,
# in its order (one generator draws them all)
SHAPES = {"mamba2 prefill S=2048": (2048, 32, 128),
          "mamba2 ragged S=2000": (2000, 32, 128),
          "jamba S=2000": (2000, 128, 16)}


def exact_y(torch, x, dt, A, Bm, Cm):
    """y of the step-by-step recurrence in float64."""
    B, S, nh, hd = x.shape
    hpg = nh // Bm.shape[2]
    h = torch.zeros((B, nh, hd, Bm.shape[3]), dtype=torch.float64,
                    device=x.device)
    ys = []
    for t in range(S):
        bt = Bm[:, t].repeat_interleave(hpg, dim=1).double()
        ct = Cm[:, t].repeat_interleave(hpg, dim=1).double()
        dtt = dt[:, t].double()
        h = torch.exp(dtt * A.double())[..., None, None] * h + torch.einsum(
            "bhp,bhs->bhps", dtt[..., None] * x[:, t].double(), bt)
        ys.append(torch.einsum("bhs,bhps->bhp", ct, h))
    return torch.stack(ys, dim=1)


def roundings(torch):
    """Part 1: shares of equal outputs at each of ``SHAPES``, drawn as
    phase 11 draws them."""
    import torch.nn.functional as F
    from repro_torch.kernels import mamba2_ssd, mamba2_ssd_plain
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for label, (S, nh, ds) in SHAPES.items():
        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda")
        x = (randn(1, S, nh, 64) * 0.5).to(torch.bfloat16)
        dt = F.softplus(randn(1, S, nh))
        A = -torch.linspace(1.0, 16.0, nh, device="cuda")
        Bm = (randn(1, S, 1, ds) * 0.5).to(torch.bfloat16)
        Cm = (randn(1, S, 1, ds) * 0.5).to(torch.bfloat16)
        y, h = mamba2_ssd(x, dt, A, Bm, Cm)
        yp, hp = mamba2_ssd_plain(x, dt, A, Bm, Cm)
        ye = exact_y(torch, x, dt, A, Bm, Cm).to(torch.bfloat16)
        out[label] = {
            "kernel_equal_plain": float((y == yp).float().mean()),
            "kernel_equal_exact": float((y == ye).float().mean()),
            "plain_equal_exact": float((yp == ye).float().mean()),
            "y_max_abs_diff": float((y.float() - yp.float()).abs().max()),
            "state_max_abs_diff": float((h - hp).abs().max())}
        print(f"{label} (nh={nh} ds={ds}): {json.dumps(out[label])}")
        del x, dt, Bm, Cm, y, h, yp, hp, ye
    torch.cuda.empty_cache()
    return out


def hybrid(torch):
    """Part 2: phase 14 on jamba's period, its failure printed."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(chip_smoke.HYBRID["arch"]),
                              n_layers=chip_smoke.HYBRID["n_layers"])
    params = chip_smoke.draw_params(torch, cfg, chip_smoke.HYBRID["seed"],
                                    f"{cfg.name}, one period")
    try:
        _, routing = chip_smoke.phase_hybrid_sync(torch, cfg, params)
        return {"passed": True, "routing": routing}
    except chip_smoke.Failure as e:
        print(f"phase 14 would fail: {e}")
        return {"passed": False, "failure": str(e)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_ssd_study: needs a CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    print(f"repro_torch from {Path(repro_torch.__file__).parent}; card "
          f"{chip_smoke.card_line()}")
    result = {"card": chip_smoke.card_line(), "roundings": roundings(torch),
              "phase_14": hybrid(torch)}
    if chip_smoke.DEFERRED:
        result["phase_14"]["deferred"] = list(chip_smoke.DEFERRED)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
