"""Continuous-batching serve demo with the PyTorch port (twin of
``examples/serve_demo.py``): a ragged request mix (staggered arrivals,
mixed prompt/output lengths) slot-filled through the block-paged KV
cache, or, for a model the paged cache cannot hold, the synchronous
bucket engine serving the same work.

    PYTHONPATH=src python examples/torch_serve_demo.py
    PYTHONPATH=src python examples/torch_serve_demo.py --arch mamba2-370m
        (non-attention mixers cannot page: served by ServeEngine)
    PYTHONPATH=src python examples/torch_serve_demo.py --device cpu

The device defaults to ``cuda`` and the run raises without one; the
model runs the kernel path (``use_kernels=True``): the paged engine's
decode ticks on ``paged_decode_attention`` and its prefill chunks on
``flash_attention``, the bucket engine's steps on ``flash_attention``
and ``decode_attention`` (on the CPU their plain versions).  Seed 0
draws the reference's trace: the same numpy calls in the same order.
"""

import argparse
import math
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import PagedServeEngine, Request, ServeEngine


def make_requests(rng, vocab, n, max_len):
    """Mostly short chat turns, a few long generations, ragged arrivals."""
    reqs = []
    tick = 0
    for _ in range(n):
        tick += int(rng.poisson(1))
        s = int(rng.integers(6, 48))
        gen = int(rng.integers(40, 80)) if rng.random() < 0.25 \
            else int(rng.integers(4, 16))
        gen = min(gen, max_len - s)
        prompt = rng.integers(0, vocab, (s,)).astype(np.int32)
        reqs.append(Request(prompt=prompt, n_steps=gen, arrival=tick))
    return reqs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCHS)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(0)
    reqs = make_requests(rng, cfg.vocab_size, args.requests, args.max_len)
    total = sum(r.n_steps for r in reqs)

    try:
        eng = PagedServeEngine(cfg, params, max_len=args.max_len,
                               max_batch=args.max_batch, device=dev)
    except NotImplementedError as e:
        # mamba2 / MLA / hybrid mixers keep state the paged cache cannot
        # hold: serve them through the synchronous bucket engine
        print(f"arch={cfg.name}: not pageable ({e}); using ServeEngine")
        s_max = max(r.prompt.shape[0] for r in reqs)
        n_max = max(r.n_steps for r in reqs)
        eng = ServeEngine(cfg, params, device=dev,
                          max_len=32 * math.ceil((s_max + n_max) / 32))
        t0 = time.perf_counter()
        # the paged engine's run(trace) protocol: one padded bucket
        # replay (batch = the whole trace)
        results, stats = eng.run(reqs, temperature=args.temperature,
                                 batch=len(reqs))
        dt = time.perf_counter() - t0
        print(f"{len(reqs)} requests, {total} requested tokens, "
              f"wall={dt:.2f}s -> {total / dt:.1f} tok/s (bucketed, "
              f"{stats['decode_steps']} decode steps)")
        for i, r in enumerate(results[:3]):
            print(f"req{i}: {r.tokens[:10].tolist()}")
        return 0

    t0 = time.perf_counter()
    results, stats = eng.run(reqs, temperature=args.temperature)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name}: {len(reqs)} ragged requests "
          f"({total} requested tokens) on {args.max_batch} slots, "
          f"page={eng.page}, pool={eng.cache.capacity} blocks")
    print(f"wall={dt:.2f}s -> {total / dt:.1f} tok/s  "
          f"({stats['decode_steps']} decode steps over {stats['ticks']} "
          f"ticks, peak occupancy {stats['occupancy_max']:.0%})")
    for i, r in enumerate(results[:3]):
        wait = r.admitted - r.arrival
        print(f"req{i}: prompt={r.prompt_len:3d} +{len(r.tokens):3d} tokens "
              f"arrived@{r.arrival} admitted@{r.admitted} "
              f"(+{wait} tick wait) => {r.tokens[:8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
