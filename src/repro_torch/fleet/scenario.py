"""Declarative traffic scenarios for the fleet capacity planner (twin of
``repro.fleet.scenario``).

A :class:`TrafficScenario` is everything the capacity model needs to
know about a workload *without* running it: which catalog model is
served, the offered request rate, the prompt/output length mix, arrival
burstiness, the serving configuration (batch slots, prefill chunk,
tensor-parallel ways) and the SLO the fleet must meet.  Scenarios live
in a registry (:func:`register_scenario`) mirroring the serve-trace and
perf-engine registries, with three built-ins:

* ``chat``          — short interactive turns, tight per-token SLO;
* ``long_context``  — document-stuffing prompts on a bigger model,
  tensor-parallel serving (the collectives show up in the cost graphs);
* ``bursty_batch``  — offline-ish batch traffic with bursty arrivals
  and a loose SLO.

Each scenario also names the :mod:`repro_torch.serve.traces` generator
whose request mix it abstracts (``trace``), so the calibration layer can
replay the *same* traffic through the real ``PagedServeEngine``.  The
fields, defaults, validation messages and built-ins are the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

__all__ = ["SLO", "TrafficScenario", "register_scenario", "get_scenario",
           "list_scenarios"]


@dataclasses.dataclass(frozen=True)
class SLO:
    """Service-level objectives the planner sizes the fleet against."""

    p99_token_ms: float = 200.0     # p99 inter-token latency target
    ttft_p99_ms: float = math.inf   # p99 time-to-first-token target

    def with_p99(self, p99_token_ms: float) -> "SLO":
        return dataclasses.replace(self, p99_token_ms=float(p99_token_ms))


@dataclasses.dataclass(frozen=True)
class TrafficScenario:
    """One traffic mix, declaratively.

    ``qps`` is the *offered* fleet-wide request rate the planner sizes
    devices for; ``prompt_mean`` / ``output_mean`` summarise the length
    mix in tokens; ``burstiness`` scales the queueing-delay term (1.0 ~
    Poisson arrivals, >1 heavier bursts).  ``max_batch`` /
    ``prefill_chunk`` / ``tp`` describe how one replica serves the
    model (``tp`` > 1 shards every layer ``tp`` ways and puts the
    tensor-parallel all-reduces into the cost graph).  ``trace`` names
    the :mod:`repro_torch.serve.traces` generator this mix
    abstracts.
    """

    name: str
    arch: str = "qwen2-7b"          # repro_torch.configs catalog model
    qps: float = 10.0               # offered fleet-wide requests/s
    prompt_mean: float = 512.0      # mean prompt tokens
    output_mean: float = 256.0      # mean generated tokens
    burstiness: float = 1.0         # arrival burstiness multiplier
    slo: SLO = dataclasses.field(default_factory=SLO)
    max_batch: int = 8              # concurrent decode slots per replica
    prefill_chunk: int = 256        # incremental-prefill chunk tokens
    tp: int = 1                     # tensor-parallel ways per replica
    trace: str = "base"             # repro_torch.serve.traces generator

    def __post_init__(self):
        if self.qps <= 0:
            raise ValueError(f"scenario {self.name!r}: qps must be > 0")
        if self.prompt_mean < 1 or self.output_mean < 1:
            raise ValueError(f"scenario {self.name!r}: prompt_mean and "
                             "output_mean must be >= 1 token")
        if self.max_batch < 1 or self.prefill_chunk < 1 or self.tp < 1:
            raise ValueError(f"scenario {self.name!r}: max_batch, "
                             "prefill_chunk and tp must be >= 1")

    @property
    def context_mean(self) -> float:
        """Mean attention context during decode: the whole prompt plus
        half the output already generated."""
        return self.prompt_mean + self.output_mean / 2.0

    @property
    def prefill_chunks_per_request(self) -> int:
        return math.ceil(self.prompt_mean / self.prefill_chunk)

    def describe(self) -> str:
        return (f"{self.name}: {self.arch}, {self.qps:g} qps, "
                f"s={self.prompt_mean:g} n={self.output_mean:g}, "
                f"slo p99={self.slo.p99_token_ms:g}ms, "
                f"batch={self.max_batch} chunk={self.prefill_chunk} "
                f"tp={self.tp}")


_REGISTRY: Dict[str, TrafficScenario] = {}


def register_scenario(scenario: TrafficScenario) -> TrafficScenario:
    """Add a scenario to the registry (returns it, for chaining)."""
    if scenario.name in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} is already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> TrafficScenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{list_scenarios()}") from None


def list_scenarios() -> List[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Built-ins
# ---------------------------------------------------------------------------

register_scenario(TrafficScenario(
    name="chat",
    arch="qwen2-7b",
    qps=20.0,
    prompt_mean=512, output_mean=256,
    burstiness=1.0,
    slo=SLO(p99_token_ms=200.0),
    max_batch=8, prefill_chunk=256, tp=1,
    trace="base",
))

register_scenario(TrafficScenario(
    name="long_context",
    arch="yi-34b",
    qps=2.0,
    prompt_mean=8192, output_mean=512,
    burstiness=1.0,
    slo=SLO(p99_token_ms=400.0),
    # a 34B model at 8k context is served tensor-parallel: the per-layer
    # all-reduces land in the cost graph and can become the bound under
    # interconnect what-ifs
    max_batch=4, prefill_chunk=512, tp=4,
    trace="long_prompt",
))

register_scenario(TrafficScenario(
    name="bursty_batch",
    arch="qwen2-7b",
    qps=40.0,
    prompt_mean=256, output_mean=128,
    burstiness=4.0,
    slo=SLO(p99_token_ms=500.0),
    max_batch=16, prefill_chunk=256, tp=1,
    trace="shared_prefix",
))
