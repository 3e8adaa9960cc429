"""Continuous-batching serve engine over the block-paged KV cache
(twin of ``repro.serve.paged_engine``).

The scheduler is the reference's, tick for tick: per request
``PENDING -> PREFILLING -> ACTIVE -> DONE`` (preemption re-queues as
PENDING and recomputes), and every tick runs the canonical order

1. faults (release expired seizures, seize blocks, note stalls);
2. cancellations, then timeouts, queued or in flight;
3. fault-forced preemptions, latest-admitted first;
4. shedding: the ``max_queue`` bound, then the admission policy;
5. admission, FIFO, taking the longest cached page-aligned prefix
   (capped at ``(s - 1) // page`` pages) and reserving prompt blocks only;
6. one prefill chunk per PREFILLING slot;
7. growth of each ACTIVE slot crossing a page boundary (exhaustion
   preempts latest-admitted first), then one decode step for every
   ACTIVE slot.

Steps 5-7 are the data plane, skipped on a stalled tick.  The CPU tests
replay traces through this engine and the reference's and require the
same statuses and tick counts, and the same greedy tokens up to
near-ties (:mod:`repro_torch.serve.parity`).

What differs from the reference is the device side.  The pools are
written in place (the reference donates them to XLA).  A decode tick
computes the greedy tokens on the device and moves one (B,) int tensor
to the host, which also waits for the tick's work.  Temperature sampling
draws from one ``torch.Generator`` seeded with ``seed`` on the engine's
device; only greedy decoding is held to the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import paged_decode_step, paged_prefill_step
from repro_torch.serve.api import (Request, RequestResult, RunStats,
                                   as_requests, sample)
from repro_torch.serve.paged_cache import (PagedKVCache, default_page_size,
                                           validate_page)
from repro_torch.serve.resilience import (CANCELLED, OK, PREEMPTED, SHED,
                                          TIMEOUT, AdmissionPolicy, FaultPlan,
                                          QueueCapPolicy, queue_entries)

__all__ = ["PagedServeEngine", "Request", "RequestResult"]


@dataclasses.dataclass
class _Slot:
    req: int                        # index into the request list
    ids: List[int]                  # held pool blocks (shared first)
    remaining: int
    filled: int                     # prompt tokens already in the pool
    registered: int                 # full pages entered in the prefix index
    seq: int                        # admission order (victim selection)


class PagedServeEngine:
    """Continuous-batching engine: ``max_batch`` slots sharing one
    :class:`PagedKVCache` pool.

    ``params`` must live on ``device`` (default ``"cuda"``; asking for
    CUDA without it raises).  ``n_blocks=None`` sizes the pool so every
    slot can hold a full ``max_len`` request plus the null block.
    ``page=None`` takes :func:`default_page_size` capped at ``max_len``.
    ``prefix_cache``, ``prefill_chunk``, ``max_queue``, ``admission``,
    ``max_preemptions`` and ``check_invariants`` mean what they mean in
    the reference."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 512,
                 max_batch: int = 8, n_blocks: Optional[int] = None,
                 page: Optional[int] = None,
                 device: Union[str, torch.device, None] = "cuda",
                 prefix_cache: bool = True, prefill_chunk: int = 32,
                 max_queue: Optional[int] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 max_preemptions: int = 8,
                 check_invariants: bool = False):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device} but "
                             f"the engine runs on {self.device}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} < 1")
        if max_preemptions < 0:
            raise ValueError(f"max_preemptions={max_preemptions} < 0")
        self.page = default_page_size(cfg, cap=max_len) if page is None \
            else validate_page(page)
        self.nb_table = math.ceil(max_len / self.page)
        if n_blocks is None:
            n_blocks = max_batch * self.nb_table + 1
        self.cfg = cfg
        self.params = params
        self.cache = PagedKVCache(cfg, n_blocks=n_blocks, page=self.page,
                                  device=self.device)
        self.max_len = max_len
        self.max_batch = max_batch
        self.prefix_cache = prefix_cache
        self.prefill_chunk = int(prefill_chunk)
        self.max_preemptions = int(max_preemptions)
        self.check_invariants = bool(check_invariants)
        self.policies: List[AdmissionPolicy] = []
        if max_queue is not None:
            self.policies.append(QueueCapPolicy(max_queue))
        if admission is not None:
            self.policies.append(admission)
        # chunks start at multiples of prefill_chunk past a page boundary,
        # so when the chunk divides the page no chunk crosses a block
        self.aligned = self.page % self.prefill_chunk == 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of host scheduler state (never an alias of it)."""
        return torch.tensor(a, device=self.device)

    def prefill(self, tokens: np.ndarray, table: np.ndarray, pos: int,
                nv: int) -> torch.Tensor:
        """One (1, prefill_chunk) chunk at global position ``pos`` with
        ``nv`` valid tokens; returns the (V,) logits of its last valid row."""
        logits = paged_prefill_step(
            self.cfg, self.params, self.cache.pools,
            self._tensor(tokens), self._tensor(table),
            self._tensor(np.array([pos], np.int32)),
            self._tensor(np.array([nv], np.int32)), aligned=self.aligned)
        return logits[0, -1]

    def decode(self, pend: np.ndarray, tables: np.ndarray,
               lens: np.ndarray) -> torch.Tensor:
        """One decode step for every slot; returns the (B, V) logits."""
        logits = paged_decode_step(
            self.cfg, self.params, self.cache.pools,
            self._tensor(pend[:, None]), self._tensor(tables),
            self._tensor(lens))
        return logits[:, -1]

    def _prompt_blocks(self, s: int) -> int:
        return max(1, math.ceil(s / self.page))

    def teacher_forced_logits(self, prompt: np.ndarray,
                              tokens: Sequence[int]) -> List[torch.Tensor]:
        """The (V,) logits behind each token of a stream: the prompt
        prefilled in this engine's chunks, then ``tokens`` fed back one
        decode step at a time, on a one-slot engine sharing this one's
        config, weights, page and chunk size (and not its pool)."""
        solo = PagedServeEngine(self.cfg, self.params, max_len=self.max_len,
                                max_batch=1, page=self.page,
                                prefill_chunk=self.prefill_chunk,
                                device=self.device)
        table = np.arange(1, solo.nb_table + 1, dtype=np.int32)[None]
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        s, C = prompt.shape[0], solo.prefill_chunk
        for pos in range(0, s, C):
            nv = min(C, s - pos)
            toks = np.zeros((1, C), np.int32)
            toks[0, :nv] = prompt[pos:pos + nv]
            logits = solo.prefill(toks, table, pos, nv)
        out = [logits]
        for t, tok in enumerate(list(tokens)[:-1]):
            out.append(solo.decode(np.array([tok], np.int32), table,
                                   np.array([s + t], np.int32))[0])
        return out

    # -- the scheduler -----------------------------------------------------

    def run(self, requests: Sequence[Request], *,
            temperature: float = 0.0, seed: int = 0,
            fault_plan: Optional[FaultPlan] = None,
            max_ticks: Optional[int] = None
            ) -> Tuple[List[RequestResult], RunStats]:
        """Serve ``requests`` until every one reaches a terminal status;
        results come back in input order.  ``fault_plan`` injects faults
        (and turns per-tick invariant checks on); ``max_ticks`` raises
        ``RuntimeError`` instead of spinning forever."""
        reqs = as_requests(requests)
        for i, r in enumerate(reqs):
            s = r.prompt.shape[0]
            if s + r.n_steps > self.max_len:
                raise ValueError(
                    f"request {i} does not fit: prompt length {s} + n_steps "
                    f"{r.n_steps} = {s + r.n_steps} exceeds this engine's "
                    f"max_len of {self.max_len}")
            need = math.ceil((s + r.n_steps) / self.page)
            if need > self.cache.capacity:
                raise ValueError(
                    f"request {i} needs {need} blocks "
                    f"(prompt {s} + n_steps {r.n_steps} = {s + r.n_steps} "
                    f"tokens at page size {self.page}) but the pool's "
                    f"capacity is {self.cache.capacity} blocks "
                    f"(n_blocks={self.cache.n_blocks} minus the null "
                    f"block); construct the engine with n_blocks >= "
                    f"{need + 1} or shorten the request")

        checking = self.check_invariants or fault_plan is not None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        results: List[Optional[RequestResult]] = [None] * len(reqs)
        out_tokens: List[List[int]] = [[] for _ in reqs]
        emit_times: List[List[float]] = [[] for _ in reqs]
        admitted_at = [-1] * len(reqs)
        admit_time = [0.0] * len(reqs)
        prefix_blocks = [0] * len(reqs)
        preempt_count = [0] * len(reqs)
        queue = collections.deque(
            sorted(range(len(reqs)), key=lambda i: (reqs[i].arrival, i)))

        B, NB = self.max_batch, self.nb_table
        slots: List[Optional[_Slot]] = [None] * B
        tables = np.zeros((B, NB), np.int32)          # null block everywhere
        lens = np.zeros((B,), np.int32)               # 0 while prefilling
        pend = np.zeros((B,), np.int32)
        seized: List[Tuple[int, List[int]]] = []      # (release_tick, ids)

        tick = 0
        seq_counter = 0
        decode_steps = 0
        prefill_chunks = 0
        blocks_reused = 0
        blocks_needed = 0
        n_shed = n_timeout = n_cancel = n_preempt = n_stalled = 0
        occupancy: List[float] = []

        def emit(rid: int, tok: int) -> None:
            out_tokens[rid].append(tok)
            emit_times[rid].append(time.perf_counter())

        def finish(rid: int, status: str, detail: str = "") -> None:
            results[rid] = RequestResult(
                tokens=np.asarray(out_tokens[rid], np.int32),
                prompt_len=reqs[rid].prompt.shape[0],
                arrival=reqs[rid].arrival, admitted=admitted_at[rid],
                finished=tick, emit_times=emit_times[rid],
                admit_time=admit_time[rid],
                prefix_blocks=prefix_blocks[rid], status=status,
                detail=detail, preemptions=preempt_count[rid])

        def clear_slot(si: int) -> None:
            self.cache.free(slots[si].ids)
            slots[si] = None
            tables[si] = 0
            lens[si] = 0
            pend[si] = 0

        def retire(si: int, status: str = OK, detail: str = "") -> None:
            rid = slots[si].req
            clear_slot(si)
            finish(rid, status, detail)

        def drop_queued(rids, status: str, detail_fn) -> None:
            nonlocal queue
            dropped = set(rids)
            if not dropped:
                return
            queue = collections.deque(r for r in queue if r not in dropped)
            for rid in rids:
                finish(rid, status, detail_fn(rid))

        def preempt(si: int, why: str) -> None:
            """Evict slot ``si``: re-queue it as PENDING for recompute or,
            past the preemption budget, retire it PREEMPTED."""
            nonlocal n_preempt
            rid = slots[si].req
            clear_slot(si)
            preempt_count[rid] += 1
            n_preempt += 1
            if preempt_count[rid] > self.max_preemptions:
                finish(rid, PREEMPTED,
                       f"evicted {preempt_count[rid]} times "
                       f"(max_preemptions={self.max_preemptions}); last "
                       f"eviction at tick {tick}: {why}")
                return
            out_tokens[rid].clear()
            emit_times[rid].clear()
            admitted_at[rid] = -1
            admit_time[rid] = 0.0
            prefix_blocks[rid] = 0
            key = (reqs[rid].arrival, rid)
            pos = 0
            for pos, q in enumerate(queue):           # sorted re-insert
                if (reqs[q].arrival, q) > key:
                    break
            else:
                pos = len(queue)
            queue.insert(pos, rid)

        def victims_latest_first() -> List[int]:
            held = [(slots[si].seq, si) for si in range(B)
                    if slots[si] is not None]
            return [si for _, si in sorted(held, reverse=True)]

        while queue or any(s is not None for s in slots):
            if max_ticks is not None and tick >= max_ticks:
                raise RuntimeError(
                    f"scheduler exceeded max_ticks={max_ticks} with "
                    f"{len(queue)} queued and "
                    f"{sum(s is not None for s in slots)} in-flight "
                    "requests — deadlock canary tripped")

            # 1. faults
            stalled = False
            if fault_plan is not None:
                keep = []
                for release, ids in seized:
                    if release <= tick:
                        self.cache.free(ids)
                    else:
                        keep.append((release, ids))
                seized = keep
                for f in fault_plan.seizures(tick):
                    k = self.cache.free_blocks if f.n is None \
                        else min(f.n, self.cache.free_blocks)
                    ids = self.cache.alloc(k) or []
                    if ids:
                        seized.append((tick + f.duration, ids))
                stalled = fault_plan.stalled(tick)
                if stalled:
                    n_stalled += 1

            # 2. cancellations, then timeouts
            cancelled = [rid for rid in queue
                         if reqs[rid].cancel_at is not None
                         and tick >= reqs[rid].cancel_at]
            drop_queued(cancelled, CANCELLED,
                        lambda rid: f"cancelled at tick "
                                    f"{reqs[rid].cancel_at} while queued")
            n_cancel += len(cancelled)
            for si in range(B):
                slot = slots[si]
                if slot is None:
                    continue
                r = reqs[slot.req]
                if r.cancel_at is not None and tick >= r.cancel_at:
                    retire(si, CANCELLED,
                           f"cancelled at tick {r.cancel_at} in flight")
                    n_cancel += 1
            timed_out = [rid for rid in queue
                         if reqs[rid].deadline is not None
                         and tick > reqs[rid].deadline]
            drop_queued(timed_out, TIMEOUT,
                        lambda rid: f"deadline {reqs[rid].deadline} passed "
                                    "while queued")
            n_timeout += len(timed_out)
            for si in range(B):
                slot = slots[si]
                if slot is None:
                    continue
                r = reqs[slot.req]
                if r.deadline is not None and tick > r.deadline:
                    retire(si, TIMEOUT,
                           f"deadline {r.deadline} passed with "
                           f"{slot.remaining} tokens still to emit")
                    n_timeout += 1

            # 3. fault-forced preemptions
            if fault_plan is not None:
                for si in victims_latest_first()[
                        :fault_plan.forced_preemptions(tick)]:
                    preempt(si, "forced by fault plan")

            # 4. shed: queue-cap bound first, then the pluggable policy
            for policy in self.policies:
                waiting = [rid for rid in queue if reqs[rid].arrival <= tick]
                if not waiting:
                    break
                entries = queue_entries(tick, waiting, reqs,
                                        self.prefill_chunk)
                verdicts = dict(policy.shed(tick, entries))
                drop_queued(list(verdicts), SHED, verdicts.__getitem__)
                n_shed += len(verdicts)

            # 5. admit: FIFO while a slot and the prompt reservation fit
            while not stalled and queue and reqs[queue[0]].arrival <= tick:
                free_slots = [i for i, s in enumerate(slots) if s is None]
                if not free_slots:
                    break
                rid = queue[0]
                r = reqs[rid]
                s = r.prompt.shape[0]
                need = self._prompt_blocks(s)
                matched: List[int] = []
                if self.prefix_cache:
                    # >= 1 suffix token must prefill (first-token logits),
                    # which also keeps later writes past the shared pages
                    matched = self.cache.match_prefix(
                        r.prompt)[:(s - 1) // self.page]
                    self.cache.acquire(matched)
                ids = self.cache.alloc(need - len(matched))
                if ids is None:
                    if matched:
                        self.cache.free(matched)
                    break
                queue.popleft()
                si = free_slots[0]
                admitted_at[rid] = tick
                admit_time[rid] = time.perf_counter()
                prefix_blocks[rid] = len(matched)
                blocks_reused += len(matched)
                blocks_needed += (s - 1) // self.page
                slots[si] = _Slot(req=rid, ids=matched + ids,
                                  remaining=r.n_steps,
                                  filled=len(matched) * self.page,
                                  registered=len(matched), seq=seq_counter)
                seq_counter += 1
                tables[si, :] = 0
                tables[si, :len(slots[si].ids)] = slots[si].ids
                lens[si] = 0                        # ACTIVE only after prefill

            occupancy.append(self.cache.occupancy())

            # 6. prefill: one chunk per PREFILLING slot
            C = self.prefill_chunk
            for si in range(B):
                slot = slots[si]
                if stalled or slot is None or lens[si] > 0:
                    continue
                r = reqs[slot.req]
                s = r.prompt.shape[0]
                pos = slot.filled
                nv = min(C, s - pos)
                toks = np.zeros((1, C), np.int32)
                toks[0, :nv] = r.prompt[pos:pos + nv]
                logits = self.prefill(toks, tables[si:si + 1], pos, nv)
                prefill_chunks += 1
                slot.filled = pos + nv
                if self.prefix_cache:
                    full = slot.filled // self.page
                    if full > slot.registered:
                        self.cache.register_prefix(
                            r.prompt[:full * self.page], slot.ids[:full])
                        slot.registered = full
                if slot.filled == s:                # prefill done -> ACTIVE
                    tok = int(sample(logits, temperature, gen))
                    lens[si] = s
                    pend[si] = tok
                    emit(slot.req, tok)
                    slot.remaining -= 1
                    if slot.remaining == 0:
                        retire(si)

            # 7a. grow: a slot writing into a fresh page allocates its
            # next block; exhaustion preempts latest-admitted first
            for si in range(B):
                if stalled:
                    break
                slot = slots[si]
                if slot is None or lens[si] == 0:
                    continue
                if int(lens[si]) < len(slot.ids) * self.page:
                    continue                        # page not full yet
                got = self.cache.alloc(1)
                if got is None:
                    for vi in victims_latest_first():
                        victim_is_self = vi == si
                        preempt(vi, "pool exhausted growing slot "
                                    f"{si} at length {int(lens[si])}")
                        if victim_is_self:
                            break
                        got = self.cache.alloc(1)
                        if got is not None:
                            break
                if got is None or slots[si] is None:
                    continue                        # grower was evicted
                slot.ids.append(got[0])
                tables[si, len(slot.ids) - 1] = got[0]

            # 7b. decode every ACTIVE slot.  PREFILLING slots sit at lens
            # 0 with a null table row, so they attend one masked null row
            # and their write lands in the null block, like idle slots.
            active = [] if stalled else \
                [i for i, sl in enumerate(slots)
                 if sl is not None and lens[i] > 0]
            if active:
                dec_tables = tables.copy()
                for si in range(B):
                    if slots[si] is not None and lens[si] == 0:
                        dec_tables[si] = 0
                logits = self.decode(pend, dec_tables, lens)
                # the tick's one device-to-host transfer (it also waits
                # for the tick's pool writes)
                toks = sample(logits, temperature, gen).cpu().numpy()
                decode_steps += 1
                lens[active] += 1
                for si in active:
                    slot = slots[si]
                    tok = int(toks[si])
                    pend[si] = tok
                    emit(slot.req, tok)
                    slot.remaining -= 1
                    if slot.remaining == 0:
                        retire(si)
            tick += 1
            if checking:
                self.cache.check_invariants()
                self._assert_refcount_exact(slots, seized)

        # the run can end inside a seizure window: hand those blocks back
        for _, ids in seized:
            self.cache.free(ids)
        seized = []
        if checking:
            self.cache.check_invariants()
            self._assert_refcount_exact(slots, seized)

        n_ok = sum(1 for r in results if r is not None and r.status == OK)
        stats = RunStats(
            requests=len(reqs),
            tokens=sum(len(t) for t in out_tokens),
            ticks=tick,
            decode_steps=decode_steps,
            prefill_chunks=prefill_chunks,
            prefix_blocks_reused=blocks_reused,
            prefix_blocks_needed=blocks_needed,
            prefix_hit_rate=(blocks_reused / blocks_needed
                             if blocks_needed else 0.0),
            occupancy_mean=float(np.mean(occupancy)) if occupancy else 0.0,
            occupancy_max=float(np.max(occupancy)) if occupancy else 0.0,
            completed=n_ok, shed=n_shed, timeouts=n_timeout,
            cancelled=n_cancel, preemptions=n_preempt,
            stalled_ticks=n_stalled,
        )
        return [r for r in results if r is not None], stats

    def generate(self, tokens: np.ndarray, *, n_steps: int = 32,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """Batch convenience mirroring ``ServeEngine.generate``: serve the
        (B, S) prompts (all arriving at tick 0) and return (B, n_steps)."""
        tokens = np.asarray(tokens, np.int32)
        reqs = [Request(prompt=row, n_steps=n_steps) for row in tokens]
        results, _ = self.run(reqs, temperature=temperature, seed=seed)
        return np.stack([r.tokens for r in results])

    def _assert_refcount_exact(self, slots, seized) -> None:
        """Every reference the pool counts must be owned by exactly one
        holder the scheduler knows: a slot's blocks or a fault seizure."""
        expected: Dict[int, int] = collections.Counter()
        for slot in slots:
            if slot is not None:
                expected.update(slot.ids)
        for _, ids in seized:
            expected.update(ids)
        for b in range(1, self.cache.n_blocks):
            if self.cache.ref_count(b) != expected.get(b, 0):
                raise AssertionError(
                    f"refcount drift on block {b}: cache counts "
                    f"{self.cache.ref_count(b)} but the scheduler holds "
                    f"{expected.get(b, 0)} references")
