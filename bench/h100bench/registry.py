"""Find the benchmark's pieces by name.

Every cell, configuration, traffic mix, metric reader, count module and
plain reference is a file under ``bench/`` named after what it defines,
so a later change adds one by adding files and entries, never by
editing a file that is there.  ``root`` (default: the checkout holding
this package) lets a test point the lookups at a copy.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Registry:
    """Lookups under ``root / "bench"`` and ``root / "BENCHMARK.json"``."""

    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root is not None else ROOT
        self.bench = self.root / "bench"
        self._modules: Dict[str, ModuleType] = {}

    def _json(self, kind: str, name: str) -> dict:
        if not _NAME.match(name):
            raise ValueError(f"{kind} name {name!r} is not a valid name")
        path = self.bench / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r} "
                                    f"(looked for {path})")
        with path.open() as f:
            return json.load(f)

    def benchmark(self) -> dict:
        with (self.root / "BENCHMARK.json").open() as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        return self._json("workloads", name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def _module(self, kind: str, name: str) -> ModuleType:
        if not _NAME.match(name):
            raise ValueError(f"{kind} name {name!r} is not a valid name")
        key = f"{kind}/{name}"
        if key not in self._modules:
            path = self.bench / kind / f"{name}.py"
            if not path.is_file():
                raise FileNotFoundError(f"no {kind} module named {name!r} "
                                        f"(looked for {path})")
            mod_name = "h100bench_" + re.sub(r"\W", "_", f"{kind}_{name}")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def metric(self, name: str) -> ModuleType:
        """The reader of one metric: ``read(run) -> float | None``."""
        return self._module("metrics", name)

    def counts(self, name: str) -> ModuleType:
        """The operation and byte counts of one kernel or step."""
        return self._module("counts", name)

    def reference(self, name: str) -> ModuleType:
        """A plain reference: ``logits(cfg, weights, tokens, ...)``."""
        return self._module("references", name)

    def metrics_of(self, cell: str, trace: bool) -> List[dict]:
        """The ``BENCHMARK.json`` metric entries a run of ``cell`` reports:
        its per-layer metrics with ``trace``, else its end-to-end ones
        (each entry without a ``workloads`` key, or one that lists the
        cell)."""
        spec = self.benchmark()
        entries = spec["per_layer" if trace else "end_to_end"]
        return [m for m in entries
                if "workloads" not in m or cell in m["workloads"]]
