"""The unified prediction pipeline: ``predict(workload, device, engine)``
(twin of ``repro.perf.pipeline``).

One entry point for every cost question — any workload form (HLO/StableHLO
text, a :class:`~repro_torch.perf.hlo_ir.KernelGraph` parsed from it or
captured from a PyTorch function by :mod:`repro_torch.perf.torch_graph`,
or a dry-run JSON artifact path), any registered device, any engine, any
overlay scenario list — returning the shared
:class:`~repro_torch.perf.report.Report` schema.  :func:`sweep` runs the
full cartesian product while the content-hashed cache guarantees each
module text is parsed exactly once.

Engines are looked up in a registry; :func:`register_engine` makes a new
cost model available to every consumer (what-if grids, sweeps, examples)
in one call.  On the H100 only the roofline engine answers
(:mod:`repro_torch.perf.engines`).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Union

from repro_torch.arch.overlay import IDENTITY, Overlay
from repro_torch.core.machine import MachineModel, as_machine
from repro_torch.perf import cache
from repro_torch.perf.engines import (CostEngine, MfmaAnalyticEngine,
                                RooflineEngine, ScoreboardEngine)
from repro_torch.perf.hlo_ir import KernelGraph
from repro_torch.perf.report import Report, format_reports

__all__ = ["predict", "sweep", "as_graph", "register_engine", "get_engine",
           "list_engines", "format_reports"]

_ENGINES: Dict[str, Callable[[], CostEngine]] = {
    "roofline": RooflineEngine,
    "mfma": MfmaAnalyticEngine,
    "scoreboard": ScoreboardEngine,
}


def register_engine(name: str, factory: Callable[[], CostEngine]) -> None:
    """Add a cost engine to the registry (``factory()`` -> engine)."""
    _ENGINES[name] = factory


def list_engines() -> List[str]:
    return list(_ENGINES)


def get_engine(engine: Union[str, CostEngine]) -> CostEngine:
    """Coerce an engine name or instance to an instance."""
    if isinstance(engine, str):
        factory = _ENGINES.get(engine)
        if factory is None:
            raise KeyError(f"unknown engine {engine!r}; registered: "
                           f"{sorted(_ENGINES)}")
        return factory()
    return engine


def as_graph(workload, *, tpu_correct: bool = True) -> KernelGraph:
    """Coerce any workload form to a :class:`KernelGraph`.

    * ``KernelGraph``         — passed through;
    * ``str`` HLO text        — parsed via the content-hashed cache;
    * path to dry-run ``.json`` — recorded aggregates (roofline-grade).
    """
    if isinstance(workload, KernelGraph):
        return workload
    if isinstance(workload, os.PathLike):
        workload = os.fspath(workload)
    if isinstance(workload, str) and workload.endswith(".json") \
            and "\n" not in workload:
        rec = cache.load_artifact(workload)
        hlo = rec.get("hlo", {})
        return KernelGraph.from_totals(
            flops=hlo.get("flops_per_device", 0.0),
            bytes_accessed=hlo.get("bytes_per_device", 0.0),
            collective_wire=hlo.get("collective_wire_bytes", 0.0),
            flash_block_bytes=hlo.get("flash_block_bytes", 0.0),
            key=f"{rec.get('arch', '?')}/{rec.get('shape', '?')}")
    if isinstance(workload, str):
        return cache.parse_cached(workload, tpu_correct=tpu_correct)
    raise TypeError("cannot interpret workload of type "
                    f"{type(workload).__name__}; pass HLO text, a "
                    "KernelGraph, or a dry-run .json path")


def _reports_for(graph: KernelGraph, base: MachineModel, eng: CostEngine,
                 overlays: Iterable[Overlay], name: str) -> List[Report]:
    import dataclasses

    from repro_torch.perf.engines import plan_for_graph
    out = []
    plan = None
    for ov in overlays:
        machine = base if ov.is_identity else base.with_overlay(ov)
        rep = eng.estimate(graph, machine)
        if rep.plan is None:
            # every engine reports the tiles the kernel layer would run
            # (overlay knobs scale timing, not the spec's tile geometry)
            if plan is None:
                plan = plan_for_graph(graph, base)
            rep = dataclasses.replace(rep, plan=plan)
        out.append(dataclasses.replace(rep, scenario=ov.describe(),
                                       workload=name))
    return out


def predict(workload, *, device: Union[str, MachineModel] = "mi300",
            engine: Union[str, CostEngine] = "mfma",
            overlays: Optional[Union[Overlay, Iterable[Overlay]]] = None,
            tpu_correct: bool = True,
            workload_name: str = "") -> Union[Report, List[Report]]:
    """Cost ``workload`` on ``device`` under ``engine``.

    ``overlays=None`` returns one baseline :class:`Report`; a single
    :class:`Overlay` returns its Report; a list returns one Report per
    scenario (the workload is parsed once for all of them).

    >>> predict(capture(prefill, cfg, params, batch, 2048),
    ...         device="h100", engine="roofline")
    >>> predict(txt, device="mi300", engine="mfma",
    ...         overlays=overlay_grid(mfma_scale=(0.5, 1, 2)))
    """
    graph = as_graph(workload, tpu_correct=tpu_correct)
    base = as_machine(device)
    eng = get_engine(engine)
    name = workload_name or graph.key
    if overlays is None:
        return _reports_for(graph, base, eng, [IDENTITY], name)[0]
    if isinstance(overlays, Overlay):
        return _reports_for(graph, base, eng, [overlays], name)[0]
    return _reports_for(graph, base, eng, list(overlays), name)


def sweep(workloads: Union[Mapping[str, object], Iterable[object]], *,
          devices: Iterable[Union[str, MachineModel]] = ("mi300",),
          engines: Iterable[Union[str, CostEngine]] = ("mfma",),
          overlays: Iterable[Overlay] = (IDENTITY,),
          tpu_correct: bool = True) -> List[Report]:
    """The fleet-wide cartesian sweep: workloads x devices x engines x
    overlays, parsing each workload exactly once.

    ``workloads`` may be a mapping (name -> HLO text / KernelGraph /
    artifact path) or a plain iterable (auto-named by content hash).
    Engine instances are shared across the whole sweep so per-engine
    memoisation (e.g. the scoreboard's measured tile loops) spans cells.
    """
    if isinstance(workloads, Mapping):
        named = list(workloads.items())
    else:
        named = [("", w) for w in workloads]
    graphs = []
    for name, w in named:
        g = as_graph(w, tpu_correct=tpu_correct)
        graphs.append((name or g.key, g))
    engs = [get_engine(e) for e in engines]
    ovs = list(overlays)
    out: List[Report] = []
    for dev in devices:
        base = as_machine(dev)
        for name, graph in graphs:
            for eng in engs:
                out.extend(_reports_for(graph, base, eng, ovs, name))
    return out
