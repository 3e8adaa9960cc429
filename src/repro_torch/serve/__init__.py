"""Serving layer (twin of ``repro.serve``): the synchronous bucket engine
(the greedy oracle), the continuous-batching engine over the
block-paged KV cache behind the shared ``run(trace)`` protocol
(:class:`ServeAPI`), their request schema, trace generators and
graceful-degradation policies."""

from repro_torch.serve.api import (Request, RequestResult,  # noqa: F401
                                   RunStats, ServeAPI, as_requests, sample)
from repro_torch.serve.engine import GenerateResult, ServeEngine  # noqa: F401
from repro_torch.serve.paged_cache import (PagedKVCache,  # noqa: F401
                                           default_page_size, prefix_digests)
from repro_torch.serve.paged_engine import PagedServeEngine  # noqa: F401
from repro_torch.serve.resilience import (CANCELLED, OK,  # noqa: F401
                                          PREEMPTED, SHED, STATUSES, TIMEOUT,
                                          AdmissionPolicy, DeadlineAwareShed,
                                          Fault, FaultPlan, FIFOPolicy,
                                          QueueCapPolicy, QueueEntry,
                                          min_service_ticks)
from repro_torch.serve.traces import (get_trace, list_traces,  # noqa: F401
                                      register_trace)
