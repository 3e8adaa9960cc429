"""Train and eval steps (twin of ``repro.train.step``).

``make_train_step(cfg)`` returns ``step(params, opt_state, batch)``:
forward and backward through :func:`repro_torch.models.loss_fn`, then
AdamW.  The reference jits it and differentiates its plain path
(``use_pallas=False``): its Pallas kernels have no derivative.  The port
differentiates with autograd on ``use_kernels=False`` for the same
reason (the CUDA kernels have no backward), and refuses a config with
``use_kernels`` instead of switching paths quietly.

The step is functional: it returns a new state and never writes its
inputs.  Gradients are taken with ``torch.autograd.grad`` over detached
``requires_grad`` views of the parameter leaves (nothing accumulates in
``.grad``), so the caller's tensors stay as they were; the controller's
replay after a failure depends on that.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES
from repro_torch.models.model import loss_fn
from repro_torch.train.optim import OptConfig, adamw_update
from repro_torch.tree import leaves, tree_map

__all__ = ["make_train_step", "make_eval_step", "loss_and_grads"]


def _check_plain(cfg: ModelConfig) -> None:
    if cfg.use_kernels:
        raise ValueError(
            f"{cfg.name}: use_kernels=True, but the CUDA kernels have no "
            "backward (nor have the reference's Pallas kernels); train on "
            "the plain path: dataclasses.replace(cfg, use_kernels=False)")


def _grads(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads) of one batch; grads in the parameters'
    dtypes and structure (zero for a leaf the loss does not read)."""
    xs = [p.detach().requires_grad_() for p in leaves(params)]
    it = iter(xs)
    loss, metrics = loss_fn(cfg, tree_map(lambda _: next(it), params), batch)
    gs = torch.autograd.grad(loss, xs, allow_unused=True,
                             materialize_grads=True)
    it = iter(gs)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def loss_and_grads(cfg: ModelConfig, params, batch: Dict,
                   microbatches: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    """(loss, {"ce", "aux"}, grads) of ``batch``.  ``microbatches`` > 1
    (default ``cfg.microbatches``) splits dim 0, accumulates the
    gradients in ``cfg.grad_accum_dtype`` and returns their mean, with the
    mean loss, CE and aux, as the reference's scan does."""
    _check_plain(cfg)
    n_micro = microbatches or cfg.microbatches
    if n_micro == 1:
        return _grads(cfg, params, batch)
    B = next(iter(batch.values())).shape[0]
    if B % n_micro:
        raise ValueError(f"batch of {B} rows does not split into "
                         f"{n_micro} microbatches")
    acc_dtype = DTYPES[cfg.grad_accum_dtype]
    bm = B // n_micro
    acc = None
    loss = ce = aux = 0.0
    for i in range(n_micro):
        mb = {k: v[i * bm:(i + 1) * bm] for k, v in batch.items()}
        l, m, g = _grads(cfg, params, mb)
        if acc is None:     # the sums are this function's own tensors
            acc = tree_map(lambda t: t.to(acc_dtype), g)
        else:
            for a, t in zip(leaves(acc), leaves(g)):
                a.add_(t)
        loss, ce, aux = loss + l, ce + m["ce"], aux + m["aux"]
        del g
    inv = 1.0 / n_micro
    for a in leaves(acc):
        a.mul_(inv)
    return loss * inv, {"ce": ce * inv, "aux": aux * inv}, acc


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[OptConfig] = None,
                    grad_transform: Optional[Callable] = None,
                    microbatches: Optional[int] = None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``,
    metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` (0-d
    tensors on the parameters' device).  ``microbatches`` > 1 enables
    gradient accumulation (default ``cfg.microbatches``);
    ``grad_transform`` maps the gradient tree before the update.  Raises
    ``ValueError`` when ``cfg.use_kernels`` is set."""
    _check_plain(cfg)
    opt_cfg = opt_cfg or OptConfig()

    def step(params, opt_state, batch) -> Tuple:
        loss, metrics, grads = loss_and_grads(cfg, params, batch,
                                              microbatches)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads,
                                                      opt_state)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``step(params, batch) -> {"loss", "ce", "aux"}`` without
    gradients."""
    def step(params, batch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, metrics = loss_fn(cfg, params, batch)
        return {"loss": loss, **metrics}
    return step
