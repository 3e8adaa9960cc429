"""End-to-end training with the PyTorch port: data pipeline ->
grad-accumulated AdamW -> fault-tolerant controller -> async checkpoints
(twin of ``examples/train_lm.py``).

Presets:
  smoke  (~1.5M params, CPU-friendly)          ~50 steps in a minute
  100m   (~100M params; a few hundred steps on the GPU)

    PYTHONPATH=src python examples/torch_train_lm.py --preset smoke \\
        --steps 50 --device cpu
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300

The device defaults to ``cuda`` and the run raises without one.  The
model trains on the plain path (``use_kernels=False``): the CUDA kernels
have no backward.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.train.fault_tolerance import FailureInjector, TrainController
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves

PRESETS = {
    # ~1.5M params: d=128, 4L, GQA 4/2 heads
    "smoke": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                  d_ff=512, vocab_size=2048, head_dim=32, batch=8,
                  seq_len=128, microbatches=2),
    # ~103M params: d=640, 10L
    "100m": dict(n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
                 d_ff=2560, vocab_size=32768, head_dim=64, batch=32,
                 seq_len=512, microbatches=4),
}


def train(preset: str = "smoke", *, steps: int = 50, ckpt_dir=None,
          ckpt_every: int = 25, inject_failure: int = -1,
          resume: bool = False, device="cuda", seed: int = 0):
    """Train ``preset`` for ``steps`` steps under the controller,
    checkpointing every ``ckpt_every`` steps into ``ckpt_dir`` (a
    directory under the system's temporary directory by default);
    ``inject_failure`` >= 0 simulates a node failure at that step;
    ``resume`` starts from the latest checkpoint there.  Returns
    (cfg, state, log, controller, seconds of training)."""
    dev = resolve_device(device)
    p = PRESETS[preset]
    cfg = ModelConfig(
        name=f"lm-{preset}", family="dense",
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], head_dim=p["head_dim"],
        microbatches=p["microbatches"], use_kernels=False)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    n = sum(t.numel() for t in leaves(params))
    print(f"model: {n / 1e6:.1f}M params  batch={p['batch']}x{p['seq_len']}"
          f"  device={dev}")

    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    step = make_train_step(cfg, opt_cfg)
    data = SyntheticLM(cfg.vocab_size, batch=p["batch"],
                       seq_len=p["seq_len"], seed=0, correlation=0.9)

    def data_fn(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in data(i).items()}

    injector = FailureInjector(at_steps=[inject_failure]) \
        if inject_failure >= 0 else None
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_torch_train_lm")
    ctl = TrainController(step, ckpt_dir, ckpt_every=ckpt_every,
                          injector=injector)
    state = (params, init_opt_state(params))
    start = 0
    if resume:
        state, start = ctl._restore(state)
        print(f"resumed from step {start}")
    t0 = time.time()
    state, log = ctl.run(state, data_fn, n_steps=steps, start_step=start)
    return cfg, state, log, ctl, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train_lm under the system's "
                         "temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="simulate a node failure at this step")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    _, _, log, ctl, dt = train(
        args.preset, steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, inject_failure=args.inject_failure,
        resume=args.resume, device=args.device)
    losses = [e["loss"] for e in log if "loss" in e]
    toks = p["batch"] * p["seq_len"] * len(losses)
    print(f"\ntrained {len(losses)} steps in {dt:.1f}s "
          f"({toks / dt:.0f} tok/s); restarts={ctl.restarts}")
    print(f"loss: first5={np.mean(losses[:5]):.4f} "
          f"last5={np.mean(losses[-5:]):.4f}")
    if ctl.stragglers.events:
        print(f"stragglers flagged: {len(ctl.stragglers.events)}")


if __name__ == "__main__":
    main()
