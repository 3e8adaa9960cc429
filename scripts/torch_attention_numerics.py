"""Where the attention kernels round, and how far that moves the sync
engine's greedy streams and logits from the plain path's, on full-width
qwen2-7b on one CUDA card (random bf16 weights from ``chip_smoke.py``'s
seed, as in ``scripts/torch_sync_study.py``).

The kernel path's attention (``models.attention._attention_kernel``) runs
as the port's kernels (``kernel``) or as one of these emulations in
PyTorch ops on the card:

* ``reference``: the reference's Pallas roundings, 64-row tiles, p and
  each tile's PV product rounded to V's dtype;
* ``fa2``: p rounded to V's dtype, PV accumulated in f32 across tiles;
* ``f32``: p and PV in f32, the output rounded once (what the port's
  kernels compute, and the plain prefill path);
* ``plain_roundings``: f32 as above for prefill; decode rounds the
  normalised probabilities to V's dtype, as the plain path's ``sdpa``.

For each it reports ``chip_smoke.py`` phase 4's stream divergences
(requests and plain margins), the relative logit distance to the plain
path of phase 4's decode step and of each of its prompts' prefills, and,
over ``--prompts`` prompts of 500-2000 tokens teacher-forced along the
plain path's greedy stream of ``--steps`` tokens, how many positions
pick another token than the plain path and at what plain margins.

    PYTHONPATH=src python3 scripts/torch_attention_numerics.py \\
        --prompts 24 --out numerics.json
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

VARIANTS = ("kernel", "reference", "fa2", "f32", "plain_roundings")
NEG = -0.7 * 3.4028234663852886e38     # the kernels' masked score


def _mask(torch, s, rows, cols, causal, kv_len):
    """Mask (B, H, S, w) scores at key columns ``cols`` for query
    ``rows``: causal (S > 1) and past ``kv_len`` (an int or (B,))."""
    if causal and s.shape[2] > 1:
        s = torch.where(cols[None, :] <= rows[:, None], s, NEG)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=s.device)
        if kl.dim() == 1:
            kl = kl[:, None, None, None]
        s = torch.where(cols < kl, s, NEG)
    return s


def whole(torch, q, k, v, causal, scale, kv_len, round_probs):
    """One softmax over all keys in f32, the probabilities rounded to V's
    dtype when ``round_probs``; the output rounded once."""
    G = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(G, 2)
    vf = v.float().repeat_interleave(G, 2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kf) * scale
    s = _mask(torch, s, torch.arange(q.shape[1], device=q.device),
              torch.arange(k.shape[1], device=q.device), causal, kv_len)
    p = torch.softmax(s, -1)
    if round_probs:
        p = p.to(v.dtype).float()
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)


def tiled(torch, q, k, v, causal, scale, kv_len, round_p, round_pv,
          tile=64):
    """The kernels' online softmax over ``tile``-row tiles of keys."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kf = k.float().repeat_interleave(G, 2)
    vf = v.float().repeat_interleave(G, 2)
    rows = torch.arange(S, device=q.device)
    m = torch.full((B, H, S, 1), NEG, device=q.device)
    l = torch.zeros((B, H, S, 1), device=q.device)
    acc = torch.zeros((B, H, S, hd), device=q.device)
    for t0 in range(0, k.shape[1], tile):
        t1 = min(k.shape[1], t0 + tile)
        s = torch.einsum("bshd,bthd->bhst", q.float(), kf[:, t0:t1]) * scale
        s = _mask(torch, s, rows, torch.arange(t0, t1, device=q.device),
                  causal, kv_len)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        if round_p:
            p = p.to(v.dtype).float()
        pv = torch.einsum("bhst,bthd->bhsd", p, vf[:, t0:t1])
        if round_pv:
            pv = pv.to(v.dtype).float()
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(q.dtype).transpose(1, 2)


def attention_as(torch, name):
    """The kernel path's attention for variant ``name``."""
    from repro_torch.models import attention
    if name == "kernel":
        return attention._attention_kernel

    def fn(q, k, v, *, causal, scale, kv_len):
        if name == "reference":
            return tiled(torch, q, k, v, causal, scale, kv_len, True, True)
        if name == "fa2":
            return tiled(torch, q, k, v, causal, scale, kv_len, True, False)
        if name == "f32":
            return whole(torch, q, k, v, causal, scale, kv_len, False)
        if name == "plain_roundings":
            return whole(torch, q, k, v, causal, scale, kv_len,
                         q.shape[1] == 1)
        raise ValueError(f"unknown variant {name}")
    return fn


# the margin-only near-tie rule these studies were first run against:
# a reference top-2 margin below it (repro_torch.serve.parity now asks
# the float32 run instead)
MARGIN_RULE = 0.05


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def study(torch, cfg, params, names, n_prompts: int, n_steps: int):
    import numpy as np
    from repro_torch.models import attention, decode_step
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.parity import divergences
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    plain = ServeEngine(plain_cfg, params, max_len=2048, device="cuda")
    reqs, _ = chip_smoke.sync_workload(cfg.vocab_size)
    p_results, _ = plain.run(reqs)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, int(s)).astype(np.int32)
               for s in rng.integers(500, 2001, n_prompts)]
    streams, plain_logits = [], []
    for prompt in prompts:
        res, _ = plain.run([Request(prompt=prompt, n_steps=n_steps)])
        streams.append([int(t) for t in res[0].tokens])
        plain_logits.append([x.float() for x in plain.teacher_forced_logits(
            prompt, streams[-1])])
    kernel = attention._attention_kernel
    out = {}
    try:
        for name in names:
            t0 = time.perf_counter()
            attention._attention_kernel = attention_as(torch, name)
            eng = ServeEngine(cfg, params, max_len=2048, device="cuda")
            div = divergences(plain, reqs, p_results, eng.run(reqs)[0])
            prompt = reqs[0].prompt[None]
            logits, cache = eng.prefill(prompt)
            tok = logits.argmax(-1)[:, None]
            step = {c.use_kernels: decode_step(
                c, params, chip_smoke._map(lambda t: t.clone(), cache), tok,
                prompt.shape[1])[0].float() for c in (cfg, plain_cfg)}
            del cache
            prefill = [rel(eng.prefill(r.prompt[None])[0].float(),
                           plain.prefill(r.prompt[None])[0].float())
                       for r in reqs]
            dists, flips = [], []
            for prompt, stream, lps in zip(prompts, streams, plain_logits):
                for lk, lp in zip(eng.teacher_forced_logits(prompt, stream),
                                  lps):
                    lk = lk.float()
                    dists.append(rel(lk, lp))
                    if int(lk.argmax()) != int(lp.argmax()):
                        top = torch.topk(lp, 2).values
                        flips.append(float(top[0] - top[1]))
            out[name] = {
                "phase4_divergences": [
                    {"request": d["request"], "step": d["step"],
                     "plain_margin": d["margin"]} for d in div],
                "phase4_above_near_tie": sum(d["margin"] >= MARGIN_RULE
                                             for d in div),
                "phase4_refused": sum(not d["accepted"] for d in div),
                "decode_step_vs_plain": rel(step[True], step[False]),
                "prefill_vs_plain": prefill,
                "positions": len(dists), "token_differs": len(flips),
                "flip_plain_margins": sorted(flips),
                "mean_vs_plain": statistics.fmean(dists),
                "seconds": time.perf_counter() - t0}
            print(f"{name}: {json.dumps(out[name])}", flush=True)
            del eng
            torch.cuda.empty_cache()
    finally:
        attention._attention_kernel = kernel
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--prompts", type=int, default=24)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_numerics: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    cfg = get_config(chip_smoke.SERVE["arch"])
    print(f"card: {chip_smoke.card_line()}")
    params = chip_smoke.draw_params(torch, cfg, chip_smoke.SERVE["seed"],
                                    f"{cfg.name} full width")
    result = {"card": chip_smoke.card_line(), "variants": study(
        torch, cfg, params, args.variants.split(","), args.prompts,
        args.steps)}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
