"""repro_torch.fleet — fleet-scale capacity planning over the perf
pipeline (twin of ``repro.fleet``).

The paper's question — "how do MCE optimizations impact the behavior of
future systems" — answered at serving-fleet granularity: replay a
declarative traffic scenario through the perf engines and the serve
layer's tick-accounting cost model, and render a throughput / latency /
cost-per-token frontier per registered device (optionally under
``repro_torch.arch`` overlay what-ifs: "what does a 2x MCE buy the
fleet").

  scenario  — TrafficScenario (request rate, length mix, SLO) + registry
              with ``chat`` / ``long_context`` / ``bursty_batch`` built-ins
  capacity  — per-request cost via ``perf.predict`` + the queueing model
              calibrated against ``PagedServeEngine`` tick accounting
              -> max sustainable QPS per device under the SLO
  frontier  — scenario x device x overlay sweep -> FleetReport rows
              (devices-needed, p99 vs SLO, tokens/s/device, cost proxy)
  cli       — ``python -m repro_torch.fleet --scenario chat --devices ...``

Pure host code over the perf pipeline and the serve layer's schema: it
launches nothing.  ``h100`` is priced by the roofline only, and ranks at
the 1.0 relative price of any device :data:`DEVICE_COST` does not list.
"""

from repro_torch.fleet.scenario import (SLO, TrafficScenario,  # noqa: F401
                                        get_scenario, list_scenarios,
                                        register_scenario)
from repro_torch.fleet.capacity import (ServeCost, SimStats,  # noqa: F401
                                        TickCosts, fit_tick_costs,
                                        max_sustainable_qps, p99_latency_s,
                                        serve_cost, simulate_trace,
                                        token_latency_s)
from repro_torch.fleet.frontier import (DEVICE_COST,  # noqa: F401
                                        FleetReport, FleetRow, frontier)

__all__ = [
    "SLO", "TrafficScenario", "register_scenario", "get_scenario",
    "list_scenarios",
    "ServeCost", "serve_cost", "token_latency_s", "p99_latency_s",
    "max_sustainable_qps", "SimStats", "simulate_trace", "TickCosts",
    "fit_tick_costs",
    "FleetRow", "FleetReport", "frontier", "DEVICE_COST",
]
