"""AdamW with a cosine schedule and global-norm clipping (twin of
``repro.train.optim``).

Moments are f32; parameters keep their dtype (bf16, no f32 master
copy), and every update is computed in f32 and rounded once.  The
update is functional: it returns new tensors and never writes its
inputs, so a caller may keep the state it started from (the
fault-tolerant controller's replay does).

Parameter trees are nested dicts, lists and tuples of tensors; the
optimizer state is ``{"m", "v"}``, trees of the parameters' structure,
and ``"step"``, a 0-d int32 tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.tree import flatten_with_path, leaves, tree_map

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "lr_schedule",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: OptConfig, step: Union[int, torch.Tensor]
                ) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to
    ``min_lr_ratio * lr`` at ``total_steps``: a 0-d f32 tensor on
    ``step``'s device (the CPU for an int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * torch.clamp((step + 1) / max(1, cfg.warmup_steps),
                                max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params) -> Dict[str, Any]:
    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    dev = next(iter(leaves(params))).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _decay_mask(path) -> bool:
    """No weight decay on norms / biases / 1-d params (standard practice),
    by the leaf's own key (its last dict key)."""
    name = ""
    for p in reversed(path):
        if isinstance(p, str):
            name = p
            break
    return name not in ("ln1", "ln2", "lnx", "final_norm", "norm", "scale",
                        "bias", "A_log", "D", "dt_bias", "conv_b", "gate",
                        "kv_norm", "bq", "bk", "bv", "bi", "bo")


def adamw_update(cfg: OptConfig, params, grads, state
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}).
    ``grads`` has the parameters' structure, in any float dtype; its
    global norm is reported before clipping."""
    step = state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    def update(path, p, g, m, v):
        gf = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(gf)
        del gf
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        if _decay_mask(path):
            upd = upd + cfg.weight_decay * p.float()
        return (p.float() - lr * upd).to(p.dtype), m2, v2

    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v in zip(flatten_with_path(params), leaves(grads),
                                  leaves(state["m"]), leaves(state["v"])):
        p2, m2, v2 = update(path, p, g, m, v)
        new_p.append(p2)
        new_m.append(m2)
        new_v.append(v2)
    new_state = {"m": _refill(state["m"], new_m),
                 "v": _refill(state["v"], new_v), "step": step + 1}
    return _refill(params, new_p), new_state, {"grad_norm": gnorm, "lr": lr}


def _refill(tree, values):
    it = iter(values)
    return tree_map(lambda _: next(it), tree)
