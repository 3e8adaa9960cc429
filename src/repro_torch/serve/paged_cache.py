"""Block-paged KV cache: a shared, reference-counted pool of KV blocks
(twin of ``repro.serve.paged_cache``).

Every attention layer owns a ``(P, page, KV, hd)`` key pool and value
pool; they are stored as two tensors ``pools["k"]`` / ``pools["v"]`` of
shape ``(L, P, page, KV, hd)``.  A request's cache is the logical
concatenation of the blocks its row of the (B, NB) block table names;
the table is shared across layers.  Physical block 0 is the reserved
null block: never allocated, idle slots point their whole table at it
and their masked writes land there.

The allocator is the reference's, line for line: per-block refcounts, a
LIFO stack of never-registered blocks, a chained-sha1 prefix index
(:func:`prefix_digests`) whose refcount-0 blocks park for revival and
are evicted oldest-first, a defensive copy-on-write :meth:`fork`, and
:meth:`check_invariants`.  The CPU tests replay one op sequence on both
and require identical state after every op.

Page size.  The reference asks its TPU planner for the page (the paged
kernel's kv tile).  The port's CUDA kernel walks pages row by row with
the page's scores in shared memory, so any page works; the default is
64 rows (32 KB of bf16 K+V per page for qwen2-7b's 4 KV heads of 128),
rounded up to a multiple of 16 and capped at the engine's ``max_len`` so
short-request engines do not attend over rows that can never hold data.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import MAX_PAGE, PAGE_QUANTUM
from repro_torch.models.blocks import layer_sigs
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype

__all__ = ["PagedKVCache", "default_page_size", "prefix_digests",
           "validate_page"]

DEFAULT_PAGE = 64


def validate_page(page: int) -> int:
    """``page`` as an int, or a ``ValueError`` saying what a page may be:
    a multiple of 16 rows up to 512, the pages the paged decode kernel
    takes (``repro_torch.kernels.decode_attention``)."""
    if isinstance(page, bool) or int(page) != page or not (
            PAGE_QUANTUM <= page <= MAX_PAGE and page % PAGE_QUANTUM == 0):
        raise ValueError(
            f"page={page!r}: a KV page must be a multiple of "
            f"{PAGE_QUANTUM} rows between {PAGE_QUANTUM} and {MAX_PAGE} "
            f"(e.g. 64 or 128)")
    return int(page)


def default_page_size(cfg: ModelConfig, *, cap: Optional[int] = None) -> int:
    """The Hopper default page: 64 rows, capped at ``cap`` (an engine's
    ``max_len``) rounded up to a multiple of 16."""
    if cap is None:
        return DEFAULT_PAGE
    return min(DEFAULT_PAGE, -(-max(1, cap) // PAGE_QUANTUM) * PAGE_QUANTUM)


def prefix_digests(tokens: np.ndarray, page: int) -> List[bytes]:
    """Chained content hashes of ``tokens``' full pages:
    ``digest[i] = sha1(digest[i-1] || tokens[i*page:(i+1)*page])``, so a
    digest identifies the whole prefix up to and including its page."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    out: List[bytes] = []
    h = b""
    for i in range(toks.shape[0] // page):
        h = hashlib.sha1(h + toks[i * page:(i + 1) * page].tobytes()).digest()
        out.append(h)
    return out


class PagedKVCache:
    """Pool tensors + refcounting allocator for one model's KV blocks.

    ``n_blocks`` counts physical blocks including the null block 0, so
    ``n_blocks - 1`` are allocatable.  ``page=None`` takes
    :func:`default_page_size`; an explicit page is validated."""

    def __init__(self, cfg: ModelConfig, *, n_blocks: int,
                 page: Optional[int] = None,
                 device: Union[str, torch.device, None] = "cuda"):
        if n_blocks < 2:
            raise ValueError(f"n_blocks={n_blocks}: need at least the null "
                             "block plus one allocatable block")
        sigs = layer_sigs(cfg)
        bad = [f"layer {i}: {s[0]}" for i, s in enumerate(sigs)
               if s[0] != "attn"]
        if cfg.mla:
            bad.append("mla latent cache")
        if bad:
            raise NotImplementedError(
                "PagedKVCache: only plain GQA attention layers page "
                f"(config {cfg.name!r} has {', '.join(bad)})")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page = default_page_size(cfg) if page is None \
            else validate_page(page)
        self.n_blocks = int(n_blocks)
        shp = (cfg.n_layers, self.n_blocks, self.page, cfg.n_kv_heads, cfg.hd)
        self.pools: Dict[str, torch.Tensor] = {
            "k": torch.zeros(shp, dtype=cdtype(cfg), device=self.device),
            "v": torch.zeros(shp, dtype=cdtype(cfg), device=self.device)}
        self._refs: List[int] = [0] * self.n_blocks
        # LIFO stack of never-registered writable blocks
        self._fresh: List[int] = list(range(self.n_blocks - 1, 0, -1))
        # refcount-0 blocks still in the prefix index, oldest-parked first
        self._parked: Dict[int, None] = {}
        self._index: Dict[bytes, int] = {}      # digest -> block
        self._digest: Dict[int, bytes] = {}     # block  -> digest

    # -- allocator ---------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable blocks (the null block excluded)."""
        return self.n_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._fresh) + len(self._parked)

    @property
    def used_blocks(self) -> int:
        return self.capacity - self.free_blocks

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks parked in the prefix index (revivable)."""
        return len(self._parked)

    def occupancy(self) -> float:
        """Fraction of allocatable blocks currently held by requests."""
        return self.used_blocks / max(1, self.capacity)

    def ref_count(self, b: int) -> int:
        return self._refs[b]

    def _check_range(self, b: int, op: str) -> None:
        if not 1 <= b < self.n_blocks:
            raise ValueError(f"{op}: block id {b} outside the "
                             f"allocatable range [1, {self.n_blocks})")

    def _deregister(self, b: int) -> None:
        d = self._digest.pop(b, None)
        if d is not None:
            del self._index[d]

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` writable blocks at refcount 1, or ``None`` if the
        pool cannot cover them (all-or-nothing).  Never-written blocks go
        first; then parked index entries are evicted oldest-first."""
        if n > self.free_blocks:
            return None
        ids: List[int] = []
        for _ in range(n):
            if self._fresh:
                b = self._fresh.pop()
            else:
                b = next(iter(self._parked))
                del self._parked[b]
                self._deregister(b)
            self._refs[b] = 1
            ids.append(b)
        return ids

    def _release(self, b: int) -> None:
        """Block ``b`` just reached refcount 0: park it if indexed."""
        if b in self._digest:
            self._parked[b] = None
        else:
            self._fresh.append(b)

    def free(self, ids: Sequence[int]) -> None:
        """Drop one reference per listed block; raises before touching
        anything on an out-of-range id or a double free."""
        counts: Dict[int, int] = {}
        for b in ids:
            self._check_range(b, "free")
            counts[b] = counts.get(b, 0) + 1
        for b, c in counts.items():
            if self._refs[b] < c:
                raise ValueError(f"free: block {b} double-freed")
        for b, c in counts.items():
            self._refs[b] -= c
            if self._refs[b] == 0:
                self._release(b)

    def acquire(self, ids: Sequence[int]) -> None:
        """Add one reference per listed block (a prefix-cache hit).
        Parked blocks revive; a block neither live nor parked raises."""
        for b in ids:
            self._check_range(b, "acquire")
            if self._refs[b] == 0 and b not in self._parked:
                raise ValueError(f"acquire: block {b} is not live or "
                                 "cached (alloc writable blocks instead)")
        for b in ids:
            self._parked.pop(b, None)
            self._refs[b] += 1

    # -- prefix index ------------------------------------------------------

    def match_prefix(self, tokens: np.ndarray) -> List[int]:
        """Longest run of cached blocks covering ``tokens``' page-aligned
        prefix (pure lookup: :meth:`acquire` the result before the next
        alloc/free)."""
        out: List[int] = []
        for d in prefix_digests(tokens, self.page):
            b = self._index.get(d)
            if b is None:
                break
            out.append(b)
        return out

    def register_prefix(self, tokens: np.ndarray, ids: Sequence[int]) -> None:
        """Enter ``tokens``' full pages, held in ``ids`` in order, into the
        prefix index; first writer wins, forked blocks are skipped."""
        ds = prefix_digests(tokens, self.page)
        if len(ds) > len(ids):
            raise ValueError(
                f"register_prefix: {len(ds)} full pages but only "
                f"{len(ids)} blocks")
        for d, b in zip(ds, ids):
            self._check_range(b, "register_prefix")
            if d in self._index or b in self._digest:
                continue
            if self._refs[b] == 0 and b not in self._parked:
                raise ValueError(f"register_prefix: block {b} is not live")
            self._index[d] = b
            self._digest[b] = d

    def check_invariants(self) -> None:
        """Raise ``AssertionError`` naming the first broken invariant:
        block conservation (fresh + parked + live == n_blocks - 1,
        disjoint), the null block untouched, non-negative refcounts,
        parked blocks at refcount 0 and indexed, and the prefix index an
        exact bijection naming only live or parked blocks."""
        P = self.n_blocks
        fresh = list(self._fresh)
        fresh_set = set(fresh)
        parked = set(self._parked)
        if len(fresh) != len(fresh_set):
            raise AssertionError(f"fresh list holds duplicates: {fresh}")
        for name, ids in (("fresh", fresh_set), ("parked", parked)):
            bad = [b for b in ids if not 1 <= b < P]
            if bad:
                raise AssertionError(f"{name} holds out-of-range or null "
                                     f"blocks: {bad}")
        neg = [b for b in range(P) if self._refs[b] < 0]
        if neg:
            raise AssertionError(f"negative refcounts on blocks {neg}")
        if self._refs[0] != 0:
            raise AssertionError(f"null block has refcount {self._refs[0]}")
        live = {b for b in range(1, P) if self._refs[b] > 0}
        if fresh_set & parked:
            raise AssertionError("blocks both fresh and parked: "
                                 f"{sorted(fresh_set & parked)}")
        if live & fresh_set:
            raise AssertionError("live blocks on the fresh list: "
                                 f"{sorted(live & fresh_set)}")
        if live & parked:
            raise AssertionError("live blocks parked: "
                                 f"{sorted(live & parked)}")
        if len(fresh_set) + len(parked) + len(live) != P - 1:
            missing = (set(range(1, P)) - fresh_set - parked - live)
            raise AssertionError(
                f"block conservation broken: fresh {len(fresh_set)} + "
                f"parked {len(parked)} + live {len(live)} != {P - 1} "
                f"(leaked blocks: {sorted(missing)})")
        bad_parked = [b for b in parked if self._refs[b] != 0]
        if bad_parked:
            raise AssertionError(f"parked blocks with nonzero refcount: "
                                 f"{bad_parked}")
        unindexed = [b for b in parked if b not in self._digest]
        if unindexed:
            raise AssertionError(f"parked blocks missing from the prefix "
                                 f"index: {unindexed}")
        if len(self._index) != len(self._digest):
            raise AssertionError(
                f"prefix index ({len(self._index)}) and reverse map "
                f"({len(self._digest)}) disagree")
        for d, b in self._index.items():
            if self._digest.get(b) != d:
                raise AssertionError(
                    f"prefix index names block {b} but the reverse map "
                    f"holds {self._digest.get(b)!r} != {d!r}")
            if b not in live and b not in parked:
                raise AssertionError(
                    f"prefix index names block {b}, which is neither "
                    "live nor parked (stale K/V would be served)")

    def fork(self, b: int) -> int:
        """Copy-on-write: a private copy of shared block ``b`` across every
        layer's pools, taking over one of ``b``'s references.  Returns the
        new (unregistered) block id."""
        self._check_range(b, "fork")
        if self._refs[b] == 0:
            raise ValueError(f"fork: block {b} has no references")
        got = self.alloc(1)
        if got is None:
            raise ValueError("fork: pool exhausted (no block for the copy)")
        dst = got[0]
        for pool in self.pools.values():
            pool[:, dst] = pool[:, b]
        self._refs[b] -= 1
        if self._refs[b] == 0:
            self._release(b)
        return dst
