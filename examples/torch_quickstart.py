"""Quickstart with the PyTorch port (twin of ``examples/quickstart.py``):
build a reduced assigned-architecture LM, train a few steps on the
synthetic stream, generate tokens, then cost the train step on real
accelerators with the unified ``repro_torch.perf.predict`` API.

    PYTHONPATH=src python examples/torch_quickstart.py [--arch qwen2-7b]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The device defaults to ``cuda`` and the run raises without one.
Training runs the plain path (``use_kernels=False``: the CUDA kernels
have no backward, and the train step refuses them); generation runs the
kernel path (``flash_attention`` for the prefill, ``decode_attention``
for each step; on the CPU their plain versions).  Where the reference
prices the compiled HLO of its loss, the port prices the loss's aten ops
captured on the meta device (``repro_torch.perf.torch_graph.capture``).
"""

import argparse
import dataclasses
from typing import List, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    train_cfg = dataclasses.replace(cfg, use_kernels=False)
    print(f"arch={cfg.name} (family={cfg.family})")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    n = sum(t.numel() for t in leaves(params))
    print(f"params: {n / 1e6:.2f}M")

    step = make_train_step(train_cfg, OptConfig(
        lr=3e-3, warmup_steps=5, total_steps=args.steps))
    opt = init_opt_state(params)
    data = SyntheticLM(cfg.vocab_size, batch=4, seq_len=64, seed=0,
                       correlation=1.0)
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data(i).items()}
        params, opt, m = step(params, opt, batch)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss={float(m['loss']):.4f}  "
                  f"gnorm={float(m['grad_norm']):.3f}  lr={float(m['lr']):.2e}")

    eng = ServeEngine(cfg, params, max_len=128, device=dev)
    prompt = data(123)["tokens"][:2, :16]
    out = eng.generate(prompt, n_steps=12)
    print("prompt :", prompt[0, -8:].tolist())
    print("decoded:", out.tokens[0].tolist())

    # The unified performance pipeline: cost THIS model's train step on
    # real accelerators, one predict() call per question.
    from repro_torch.arch import Overlay
    from repro_torch.models.model import loss_fn
    from repro_torch.perf import predict
    from repro_torch.perf.torch_graph import capture, meta_params, meta_tokens

    shape = tuple(batch["tokens"].shape)
    graph = capture(loss_fn, train_cfg, meta_params(train_cfg),
                    {"tokens": meta_tokens(shape),
                     "labels": meta_tokens(shape)})
    print("\nwhat-if: one train step, unified repro_torch.perf predict()")
    for device, engine in (("mi300", "mfma"), ("mi300", "scoreboard"),
                           ("tpu_v5e", "roofline"), ("h100", "roofline")):
        r = predict(graph, device=device, engine=engine)
        print(f"  {device:8s} {engine:10s} {r.total_time_s * 1e6:9.1f}us "
              f"({r.bound}-bound)")
    r2 = predict(graph, device="mi300", engine="mfma",
                 overlays=Overlay(mfma_scale=0.5, label="2x faster MCE"))
    print(f"  {'mi300':8s} {'mfma':10s} {r2.total_time_s * 1e6:9.1f}us "
          f"under scenario [{r2.scenario}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
