"""Sharded meta-device inputs for every (arch x shape) cell (twin of
``repro.launch.specs``).

Everything here is abstract: the parameter, optimizer-state, cache and
batch trees hold DTensors whose local tensors live on the ``meta``
device, laid out by the model's axis rules on the given mesh
(``param_axes_rule``, ``cache_axes_rule``, ``batch`` on dim 0).  They
carry shapes, dtypes and placements and allocate nothing, as the
reference's ``ShapeDtypeStruct``s with ``NamedSharding``s do.  Without a
mesh the leaves are plain meta tensors.  The same specs drive the
dry-run and the roofline, so both measure the same program.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES
from repro_torch.parallel.api import named_sharding
from repro_torch.perf.torch_graph import meta_cache, meta_params
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_map, tree_map_with_path

__all__ = ["sharded_abstract", "batch_specs", "cell_fn_and_specs",
           "abstract_params", "abstract_opt_state", "abstract_cache",
           "meta_dtensor"]


def meta_dtensor(shape, dtype: torch.dtype, mesh, placements):
    """A DTensor of global ``shape`` on ``mesh`` whose local block is a
    meta tensor (even blocks: every sharded dim divides by its axes)."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= mesh.size(m)
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, list(placements), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def sharded_abstract(tree, rule: Callable, mesh):
    """``tree``'s tensors as meta tensors, or as meta DTensors on ``mesh``
    laid out by the (path, leaf) -> logical-axes ``rule``."""
    def f(path, leaf):
        if mesh is None:
            return torch.empty(tuple(leaf.shape), dtype=leaf.dtype,
                               device="meta")
        return meta_dtensor(tuple(leaf.shape), leaf.dtype, mesh,
                            named_sharding(leaf.shape, rule(path, leaf),
                                           mesh))
    return tree_map_with_path(f, tree)


def abstract_params(cfg: ModelConfig, mesh):
    return sharded_abstract(meta_params(cfg), model_lib.param_axes_rule, mesh)


def abstract_opt_state(cfg: ModelConfig, params_abstract, mesh):
    """AdamW's state for ``params_abstract``, laid out as the parameters
    are (the moment leaves keep their parameter's name in their path)."""
    plain = tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                           device="meta"), params_abstract)
    return sharded_abstract(init_opt_state(plain), model_lib.param_axes_rule,
                            mesh)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, mesh):
    return sharded_abstract(meta_cache(cfg, batch, max_len),
                            model_lib.cache_axes_rule, mesh)


def _batch_rule(path, leaf):
    return ("batch",) + (None,) * (len(leaf.shape) - 1)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                with_labels: bool) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    dt = DTYPES[cfg.dtype]

    def t(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    b = {"tokens": t((B, S), torch.int32)}
    if with_labels:
        b["labels"] = t((B, S), torch.int32)
    if cfg.cross_attn:
        b["media"] = t((B, cfg.cross_attn.n_media_tokens, cfg.d_model), dt)
    if cfg.encoder:
        b["frames"] = t((B, cfg.encoder.n_frames, cfg.d_model), dt)
    return sharded_abstract(b, _batch_rule, mesh)


def cell_fn_and_specs(arch: str, shape: ShapeSpec, mesh,
                      cfg: Optional[ModelConfig] = None,
                      opt_cfg: Optional[OptConfig] = None
                      ) -> Tuple[Callable, Tuple]:
    """The function this cell runs and its abstract, sharded arguments.

    train   -> make_train_step's step(params, opt_state, batch)
    prefill -> prefill(params, batch)            (last-token logits + cache)
    decode  -> decode_step(params, cache, tokens, pos): one new token at
               position seq_len - 1 of a seq_len cache (the reference's
               ``pos`` is an abstract scalar; the port's is an int)
    """
    cfg = cfg or get_config(arch)
    params = abstract_params(cfg, mesh)

    if shape.kind == "train":
        step = make_train_step(cfg, opt_cfg)
        opt = abstract_opt_state(cfg, params, mesh)
        batch = batch_specs(cfg, shape, mesh, with_labels=True)
        return step, (params, opt, batch)

    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape, mesh, with_labels=False)
        fn = functools.partial(model_lib.prefill, cfg, max_len=shape.seq_len)
        return (lambda p, b: fn(p, b)), (params, batch)

    cache = abstract_cache(cfg, shape.global_batch, shape.seq_len, mesh)
    tokens = sharded_abstract(
        {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                               device="meta")}, _batch_rule, mesh)["tokens"]
    fn = functools.partial(model_lib.decode_step, cfg)
    return fn, (params, cache, tokens, shape.seq_len - 1)
