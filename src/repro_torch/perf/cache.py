"""Content-hashed memoization of parsed kernel graphs + dry-run artifacts
(twin of ``repro.perf.cache``).

A full (arch x shape x device x overlay x engine) sweep used to re-parse
each HLO module once per estimator; with this cache it parses exactly once
per distinct module text (asserted by ``tests/test_torch_perf_cache.py``).
Keys are content hashes, so identical text from different callers shares
one entry and a recompiled (changed) module can never serve stale costs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict

from repro_torch.perf.hlo_ir import KernelGraph, graph_key, parse_module

__all__ = ["parse_cached", "load_artifact", "cache_stats", "clear_cache",
           "CacheStats"]

_MAX_GRAPHS = 64          # parsed modules are a few MB each at most
_MAX_ARTIFACTS = 256


@dataclasses.dataclass
class CacheStats:
    parses: int = 0        # cache misses: full text parses performed
    hits: int = 0
    artifact_loads: int = 0
    artifact_hits: int = 0


_stats = CacheStats()
_graphs: "OrderedDict[str, KernelGraph]" = OrderedDict()
_artifacts: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()


def parse_cached(text: str, *, tpu_correct: bool = True) -> KernelGraph:
    """:func:`repro_torch.perf.hlo_ir.parse_module`, memoised on content hash."""
    key = f"{graph_key(text)}:{int(tpu_correct)}"
    hit = _graphs.get(key)
    if hit is not None:
        _graphs.move_to_end(key)
        _stats.hits += 1
        return hit
    _stats.parses += 1
    graph = parse_module(text, tpu_correct=tpu_correct)
    _graphs[key] = graph
    while len(_graphs) > _MAX_GRAPHS:
        _graphs.popitem(last=False)
    return graph


def load_artifact(path) -> Dict[str, Any]:
    """A dry-run JSON record, memoised on file content hash.

    Sweeps over the same artifact directory (roofline + what-if + bench)
    read each record once per content version; editing or regenerating a
    record invalidates its entry automatically.
    """
    raw = Path(path).read_bytes()
    key = hashlib.sha256(raw).hexdigest()[:16]
    hit = _artifacts.get(key)
    if hit is not None:
        _artifacts.move_to_end(key)
        _stats.artifact_hits += 1
        return hit
    _stats.artifact_loads += 1
    rec = json.loads(raw)
    _artifacts[key] = rec
    while len(_artifacts) > _MAX_ARTIFACTS:
        _artifacts.popitem(last=False)
    return rec


def cache_stats() -> CacheStats:
    return dataclasses.replace(_stats)


def clear_cache() -> None:
    _graphs.clear()
    _artifacts.clear()
    _stats.parses = _stats.hits = 0
    _stats.artifact_loads = _stats.artifact_hits = 0
