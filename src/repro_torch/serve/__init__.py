"""Serving layer (twin of ``repro.serve``): the continuous-batching engine
over the block-paged KV cache, its request schema, trace generators and
graceful-degradation policies.  The reference's synchronous
``ServeEngine`` is the next slice."""

from repro_torch.serve.api import (Request, RequestResult,  # noqa: F401
                                   RunStats, as_requests)
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
