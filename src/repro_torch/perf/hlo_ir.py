"""One HLO -> :class:`KernelGraph` parser for the whole performance stack
(twin of ``repro.perf.hlo_ir``; stdlib only).

The IR and the parser are copied as they are, so the port's cost engines
take the same inputs as the reference's: HLO or StableHLO text, a
:class:`KernelGraph`, or a dry-run JSON record.  The port's own models
reach the same IR through :mod:`repro_torch.perf.torch_graph`, which
records the aten ops of a PyTorch function instead of parsing text.
Everything textual lives here, once:

* the per-element byte table (:data:`BYTES_PER_ELEM`, also the
  planner's, :mod:`repro_torch.kernels.plan`),
* the shape / dot-dims / replica-group / StableHLO regexes,
* the ``while`` trip-count walk (``known_trip_count`` backend config with a
  ``compare(..., constant(N), direction=LT)`` condition fallback, nested
  loops multiply, unknown loops fall back to 1),
* the XLA:CPU bf16->f32 dot-legalisation ``convert`` accounting
  (both the TPU byte correction and the dry-run upcast-buffer estimate).

:func:`parse_module` returns a :class:`KernelGraph` of typed
:class:`KernelOp` entries — dots with B/M/N/K + dtype, collectives with
ring-model wire bytes, memory-bound ops with kernel-boundary bytes — plus
module-level aggregates.  Cost engines (:mod:`repro_torch.perf.engines`)
consume the graph; they never see HLO text.
``repro_torch.core.hlo_bridge`` and ``repro_torch.core.hlo_analysis`` are
thin compatibility shims over this module.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

__all__ = [
    "BYTES_PER_ELEM", "DotOp", "KernelOp", "KernelGraph",
    "parse_module", "parse_static_dots", "parse_collectives_static",
    "collective_wire_bytes", "cpu_upcast_bytes", "graph_key",
]

# ---------------------------------------------------------------------------
# The ONE byte table
# ---------------------------------------------------------------------------

BYTES_PER_ELEM = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s32": 4, "u32": 4, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s64": 8, "u64": 8, "pred": 1, "s4": 1, "u4": 1,
}

# ---------------------------------------------------------------------------
# The ONE regex home
# ---------------------------------------------------------------------------

SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
DEF_RE = re.compile(r"(%[\w.\-]+)\s*=\s*(\w+)\[([\d,]*)\]")
DOT_RE = re.compile(
    r"=\s*(\w+)\[([\d,]*)\][^\s]*\s+dot\(([^)]*)\)\s*,\s*(.*)")
DIMS_RE = {
    "lhs_b": re.compile(r"lhs_batch_dims=\{([\d,]*)\}"),
    "rhs_b": re.compile(r"rhs_batch_dims=\{([\d,]*)\}"),
    "lhs_c": re.compile(r"lhs_contracting_dims=\{([\d,]*)\}"),
    "rhs_c": re.compile(r"rhs_contracting_dims=\{([\d,]*)\}"),
}
COLL_RE = re.compile(
    r"\s(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")
GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
# StableHLO (lowered, pre-partitioning) forms:
SH_DOT_RE = re.compile(
    r"stablehlo\.dot_general\s+[^:]*?"
    r"(?:batching_dims\s*=\s*\[([\d, ]*)\]\s*x\s*\[[\d, ]*\]\s*,\s*)?"
    r"contracting_dims\s*=\s*\[([\d, ]*)\]\s*x\s*\[([\d, ]*)\][^:]*:\s*"
    r"\(tensor<([^>]+)>,\s*tensor<([^>]+)>\)")
SH_CONV_RE = re.compile(r"stablehlo\.convolution")
# computation-structure parsing:
# note: parameter lists may contain nested parens (tuple params), so match
# loosely: name, open-paren, anything, '->', anything, trailing '{'
COMP_HDR_RE = re.compile(r"^\s*(?:ENTRY\s+)?(%[\w.\-]+)\s*\(.*->.*\{\s*$")
OP_RE = re.compile(r"^\s*(?:ROOT\s+)?(%[\w.\-]+)\s*=\s*(.*)$")
RESULT_SHAPES_RE = re.compile(r"(\w+)\[([\d,]*)\]")
TRIP_RE = re.compile(r'"known_trip_count"\s*:\s*\{\s*"n"\s*:\s*"(\d+)"')
WHILE_ATTR_RE = re.compile(r"condition=(%[\w.\-]+),\s*body=(%[\w.\-]+)")
CONST_RE = re.compile(r"(%[\w.\-]+)\s*=\s*\w+\[\]\s*constant\((\d+)\)")
# XLA:CPU upcast-convert accounting:
CONVERT_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%[\w.\-]+\s*=\s*f32\[([\d,]+)\][^\s]*\s+convert\(")
HDR_RE = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*\{\s*$")

# ops that don't touch memory / are name-plumbing only
FREE_OPS = {"parameter", "constant", "get-tuple-element", "tuple", "bitcast",
            "after-all", "add-dependency", "partition-id", "replica-id",
            "iota"}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")


# ---------------------------------------------------------------------------
# Typed ops + graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DotOp:
    """One matmul site (legacy shape, kept for the hlo_bridge API)."""

    in_dtype: str          # HLO dtype of operands ("bf16", "f32", ...)
    batch: int
    m: int
    n: int
    k: int

    @property
    def macs(self) -> int:
        return self.batch * self.m * self.n * self.k

    @property
    def flops(self) -> int:
        return 2 * self.macs


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """One typed node of a :class:`KernelGraph`.

    ``kind``: ``"dot"`` (B/M/N/K + dtype), ``"collective"`` (result +
    ring-model wire bytes, group size) or ``"memory"`` (kernel-boundary
    bytes, aggregated per opcode).  ``count`` is the *executed* multiplier
    — the product of enclosing ``while`` trip counts; per-execution
    quantities (``flops``, ``bytes``, ``wire_bytes``) must be multiplied
    by it for module totals.  Exception: ``"memory"`` ops are per-opcode
    aggregates over computations with differing multipliers, so they
    carry ``count=1.0`` and already-loop-summed ``bytes`` (consistently,
    ``count * bytes`` is the module total for every kind).
    """

    kind: str
    opcode: str
    count: float = 1.0
    dtype: str = ""
    batch: int = 0
    m: int = 0
    n: int = 0
    k: int = 0
    bytes: float = 0.0        # kernel-boundary bytes per execution
    wire_bytes: float = 0.0   # collective wire bytes per execution
    group: int = 1            # collective replica-group size

    @property
    def in_dtype(self) -> str:
        """Alias so cost engines can treat dot KernelOps like DotOps."""
        return self.dtype

    @property
    def macs(self) -> int:
        return self.batch * self.m * self.n * self.k

    @property
    def flops(self) -> int:
        return 2 * self.macs

    def as_dot(self) -> DotOp:
        return DotOp(in_dtype=self.dtype, batch=self.batch, m=self.m,
                     n=self.n, k=self.k)

    @property
    def label(self) -> str:
        if self.kind == "dot":
            return (f"dot[{self.batch}x{self.m}x{self.n}x{self.k}]"
                    f"{self.dtype}")
        if self.kind == "collective":
            return f"{self.opcode}(g={self.group})"
        return self.opcode


@dataclasses.dataclass
class KernelGraph:
    """The parsed per-device module: typed ops + loop-aware aggregates."""

    ops: List[KernelOp] = dataclasses.field(default_factory=list)
    flops: float = 0.0                   # loop-aware total (per device)
    bytes_accessed: float = 0.0          # loop-aware kernel-boundary bytes
    collective_wire: float = 0.0         # loop-aware per-device wire bytes
    flash_block_bytes: float = 0.0       # flash-attn block intermediates
    bytes_by_opcode: Dict[str, float] = dataclasses.field(default_factory=dict)
    key: str = ""                        # content hash of the source text
    source: str = "hlo"                  # "hlo" | "totals" | "torch"

    def dot_pairs(self) -> List[Tuple[KernelOp, float]]:
        """(dot, executed-count) pairs — the analytic engines' input."""
        return [(op, op.count) for op in self.ops if op.kind == "dot"]

    @property
    def dots(self) -> List[KernelOp]:
        return [op for op in self.ops if op.kind == "dot"]

    @property
    def collectives(self) -> Dict[str, Dict[str, float]]:
        """Legacy per-kind stats dict: {kind: count/result_bytes/wire_bytes}."""
        out: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0.0, "result_bytes": 0.0, "wire_bytes": 0.0})
        for op in self.ops:
            if op.kind != "collective":
                continue
            st = out[op.opcode]
            st["count"] += op.count
            st["result_bytes"] += op.count * op.bytes
            st["wire_bytes"] += op.count * op.wire_bytes
        return dict(out)

    @classmethod
    def from_totals(cls, *, flops: float = 0.0, bytes_accessed: float = 0.0,
                    collective_wire: float = 0.0,
                    flash_block_bytes: float = 0.0,
                    key: str = "") -> "KernelGraph":
        """A degenerate graph from recorded aggregates (e.g. a dry-run JSON
        artifact that stored totals but not the HLO text) — enough for the
        roofline engine, which only consumes module sums."""
        return cls(ops=[], flops=flops, bytes_accessed=bytes_accessed,
                   collective_wire=collective_wire,
                   flash_block_bytes=flash_block_bytes, key=key,
                   source="totals")


def graph_key(text: str) -> str:
    """Content hash identifying a parsed module (cache key)."""
    return hashlib.sha256(text.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Low-level helpers
# ---------------------------------------------------------------------------

def _parse_int_list(s: str) -> List[int]:
    s = s.strip()
    return [int(x) for x in s.split(",")] if s else []


def _tensor_sig(sig: str) -> Tuple[str, List[int]]:
    """'256x1024xbf16' -> ('bf16', [256, 1024]); '8xf32' -> ('f32', [8])."""
    parts = sig.split("x")
    dims, dtype = [], parts[-1]
    for p in parts[:-1]:
        dims.append(int(p))
    return dtype, dims


def _mnk(ldims, rdims, lhs_b, lhs_c, rhs_b, rhs_c) -> Tuple[int, int, int, int]:
    batch = 1
    for d in lhs_b:
        batch *= ldims[d]
    k_total = 1
    for d in lhs_c:
        k_total *= ldims[d]
    m_total = 1
    for i, d in enumerate(ldims):
        if i not in lhs_b and i not in lhs_c:
            m_total *= d
    n_total = 1
    for i, d in enumerate(rdims):
        if i not in rhs_b and i not in rhs_c:
            n_total *= d
    return batch, m_total, n_total, k_total


def _shape_bytes(dtype: str, dims: List[int]) -> float:
    if dtype not in BYTES_PER_ELEM:
        return 0.0
    size = 1
    for d in dims:
        size *= d
    return float(size * BYTES_PER_ELEM[dtype])


def _wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Ring-algorithm accounting: bytes one device moves over links.

      all-gather:         result * (g-1)/g      (receives all other shards)
      reduce-scatter:     result * (g-1)        (operand = result*g)
      all-reduce:         2 * result * (g-1)/g  (RS + AG phases)
      all-to-all:         result * (g-1)/g
      collective-permute: result                (one hop)
    """
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind in ("all-to-all", "ragged-all-to-all"):
        return nbytes * (g - 1) / g
    return nbytes  # collective-permute: one hop


def _group_size(line: str) -> int:
    m = GROUPS_RE.search(line)           # replica_groups=[G,S]<=[N]
    if m:
        return int(m.group(2))
    m = GROUPS_LIST_RE.search(line)      # replica_groups={{0,1,2,3},...}
    if m:
        return len([x for x in m.group(1).split(",") if x.strip()])
    return 1


def _split_computations(text: str) -> Dict[str, List[str]]:
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    entry_alias = None
    for line in text.splitlines():
        m = COMP_HDR_RE.match(line)
        if m and line.rstrip().endswith("{"):
            cur = m.group(1)
            comps[cur] = []
            if line.lstrip().startswith("ENTRY"):
                entry_alias = cur
            continue
        if cur is not None:
            if line.strip() == "}":
                cur = None
            else:
                comps[cur].append(line)
    if entry_alias is not None:
        comps["__entry__"] = comps[entry_alias]
    return comps


def _symbol_table(text: str) -> Dict[str, Tuple[str, List[int]]]:
    sym: Dict[str, Tuple[str, List[int]]] = {}
    for line in text.splitlines():
        m = OP_RE.match(line)
        if not m:
            continue
        name, rhs = m.groups()
        sm = RESULT_SHAPES_RE.search(rhs)
        if sm:
            sym[name] = (sm.group(1), _parse_int_list(sm.group(2)))
    return sym


def _opcode_of(rhs: str) -> Optional[str]:
    """Opcode from an op right-hand side like 'f32[8]{0} fusion(...)'."""
    m = re.match(r"^(?:\([^=]*?\)|[\w\[\]{},:#\*]+)\s+([\w\-]+)", rhs)
    return m.group(1) if m else None


def _operand_names(rhs: str) -> List[str]:
    lp = rhs.find("(")
    if lp < 0:
        return []
    depth, end = 0, -1
    for i in range(lp, len(rhs)):
        if rhs[i] == "(":
            depth += 1
        elif rhs[i] == ")":
            depth -= 1
            if depth == 0:
                end = i
                break
    if end < 0:
        return []
    inner = rhs[lp + 1:end]
    return re.findall(r"%[\w.\-]+", inner)


def _trip_count(line: str, cond_name: str,
                comps: Dict[str, List[str]]) -> float:
    """Trip count of a ``while`` op: the ``known_trip_count`` backend
    config when present, else the condition's
    ``compare(induction, constant(N), direction=LT)`` pattern, else 1
    (unknown-trip-count fallback: charge the body once)."""
    m = TRIP_RE.search(line)
    if m:
        return float(m.group(1))
    consts = {}
    for cl in comps.get(cond_name, []):
        cm = CONST_RE.search(cl)
        if cm:
            consts[cm.group(1)] = int(cm.group(2))
    for cl in comps.get(cond_name, []):
        if "compare(" in cl and "direction=LT" in cl:
            for name in _operand_names(cl.split("=", 1)[1]):
                if name in consts:
                    return float(consts[name])
    return 1.0


def _convert_sources(text: str,
                     sym: Dict[str, Tuple[str, List[int]]]) -> Dict[str, str]:
    """name -> source dtype for every ``convert`` op (used to charge
    XLA:CPU's bf16->f32 dot-legalisation converts at bf16 width: those
    converts don't exist on TPU, whose MXU consumes bf16 natively)."""
    out = {}
    for line in text.splitlines():
        m = OP_RE.match(line)
        if not m:
            continue
        name, rhs = m.groups()
        if not re.match(r"^\S+\s+convert\(", rhs):
            continue
        ops = re.findall(r"%[\w.\-]+", rhs[rhs.find("("):])
        if ops and ops[0] in sym:
            out[name] = sym[ops[0]][0]
    return out


# ---------------------------------------------------------------------------
# Static dot parsing (each site counted once; StableHLO or post-SPMD HLO)
# ---------------------------------------------------------------------------

def _parse_stablehlo_dots(text: str) -> List[KernelOp]:
    out: List[KernelOp] = []
    for m in SH_DOT_RE.finditer(text):
        bdims_s, lc_s, rc_s, lsig, rsig = m.groups()
        ldt, ldims = _tensor_sig(lsig)
        rdt, rdims = _tensor_sig(rsig)
        lhs_b = _parse_int_list((bdims_s or "").replace(" ", ""))
        # batching dims are leading & symmetric in stablehlo's pretty form
        rhs_b = list(lhs_b)
        lhs_c = _parse_int_list(lc_s.replace(" ", ""))
        rhs_c = _parse_int_list(rc_s.replace(" ", ""))
        b, mm, nn, kk = _mnk(ldims, rdims, lhs_b, lhs_c, rhs_b, rhs_c)
        out.append(KernelOp(kind="dot", opcode="dot", dtype=ldt,
                            batch=b, m=mm, n=nn, k=kk))
    return out


def _parse_hlo_dots(text: str) -> List[KernelOp]:
    # symbol table: %name -> (dtype, dims) for operand resolution
    sym: Dict[str, Tuple[str, List[int]]] = {}
    for m in DEF_RE.finditer(text):
        sym[m.group(1)] = (m.group(2), _parse_int_list(m.group(3)))
    out: List[KernelOp] = []
    for line in text.splitlines():
        if " dot(" not in line:
            continue
        m = DOT_RE.search(line)
        if not m:
            continue
        odt, odims_s, operands, attrs = m.groups()
        dims = {k: _parse_int_list(rx.search(attrs).group(1))
                if rx.search(attrs) else [] for k, rx in DIMS_RE.items()}
        # operands: either inline-shaped or bare %names
        inline = SHAPE_RE.findall(operands)
        names = [t.strip().split(" ")[-1] for t in operands.split(",")]
        if len(inline) >= 2:
            (ldt, ls), (rdt, rs) = inline[0], inline[1]
            ldims, rdims = _parse_int_list(ls), _parse_int_list(rs)
        elif len(names) >= 2 and names[0] in sym and names[1] in sym:
            (ldt, ldims), (rdt, rdims) = sym[names[0]], sym[names[1]]
        else:
            # fall back: derive M,N from output; K unknown -> skip
            continue
        b, mm, nn, kk = _mnk(ldims, rdims, dims["lhs_b"], dims["lhs_c"],
                             dims["rhs_b"], dims["rhs_c"])
        out.append(KernelOp(kind="dot", opcode="dot", dtype=ldt,
                            batch=b, m=mm, n=nn, k=kk))
    return out


def parse_static_dots(text: str) -> List[KernelOp]:
    """Extract every dot op (each counted once, even inside while bodies).

    Accepts StableHLO (``lowered.as_text()`` — preserves bf16 operand types,
    global shapes) or post-SPMD HLO (``compiled.as_text()`` — per-device
    shapes; XLA:CPU upcasts bf16 dots to f32, a backend artifact).
    """
    if "stablehlo.dot_general" in text:
        return _parse_stablehlo_dots(text)
    return _parse_hlo_dots(text)


def parse_collectives_static(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Per-collective-kind stats from post-SPMD HLO text, each op counted
    once (no loop awareness — see :func:`parse_module` for that).

    Returns {kind: {count, result_bytes, wire_bytes}}.
    """
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0})
    for line in hlo_text.splitlines():
        m = COLL_RE.search(line)
        if not m:
            continue
        kind, start = m.group(1), m.group(2)
        if f"{kind}-done" in line:
            continue  # async completion: payload counted at -start
        head = line.split(f" {kind}", 1)[0]
        shapes = SHAPE_RE.findall(head)
        if not shapes:
            continue
        # async -start results are tuples (operand, result, ...): take last
        dt, dims_s = shapes[-1]
        if dt not in BYTES_PER_ELEM:
            continue
        size = 1
        for d in _parse_int_list(dims_s):
            size *= d
        nbytes = float(size * BYTES_PER_ELEM[dt])
        g = max(1, _group_size(line))
        st = stats[kind]
        st["count"] += 1
        st["result_bytes"] += nbytes
        st["wire_bytes"] += _wire_bytes(kind, nbytes, g)
    return dict(stats)


def collective_wire_bytes(hlo_text: str) -> float:
    """Total per-device wire bytes across all collectives (static count)."""
    return sum(v["wire_bytes"]
               for v in parse_collectives_static(hlo_text).values())


# ---------------------------------------------------------------------------
# XLA:CPU upcast-buffer estimate
# ---------------------------------------------------------------------------

def cpu_upcast_bytes(hlo_text: str) -> int:
    """XLA:CPU legalises bf16 dots by hoisting whole-buffer f32 converts
    (often outside loops).  These buffers don't exist on TPU (native bf16
    MXU operands) — estimate their total so the roofline can report a
    TPU-corrected temp size alongside the raw CPU number."""
    total = 0
    in_fused = False
    for line in hlo_text.splitlines():
        h = HDR_RE.match(line)
        if h:
            in_fused = "fused" in h.group(1) or "region" in h.group(1)
            continue
        if in_fused:
            continue
        m = CONVERT_RE.match(line)
        if not m:
            continue
        dims = m.group(1)
        n = 1
        for d in dims.split(","):
            n *= int(d)
        if n * 4 < 64 * 2**20:
            continue
        if f"bf16[{dims}]" in hlo_text:   # converts a bf16 buffer of same shape
            total += n * 4
    return total


# ---------------------------------------------------------------------------
# The loop-aware module parser
# ---------------------------------------------------------------------------

def parse_module(text: str, *, tpu_correct: bool = True) -> KernelGraph:
    """Parse a post-SPMD module into a loop-aware :class:`KernelGraph`.

    Computations reachable from ENTRY via ``while(body=..., condition=...)``
    accumulate ``multiplier = parent_multiplier * trip_count``; per executed
    computation we account dot FLOPs (operand shapes resolved through a
    module-wide symbol table), kernel-boundary bytes for every
    materialising op, and per-kind collective wire bytes.  With
    ``tpu_correct`` (default) XLA:CPU's bf16->f32 dot-legalisation converts
    are charged at bf16 width (they don't exist on TPU).
    """
    comps = _split_computations(text)
    sym = _symbol_table(text)
    cvt_src = _convert_sources(text, sym) if tpu_correct else {}

    def shape_bytes_of(name: str) -> float:
        if name not in sym:
            return 0.0
        dt, dims = sym[name]
        if tpu_correct and dt == "f32" and cvt_src.get(name) == "bf16":
            dt = "bf16"           # TPU keeps the native bf16 operand
        return _shape_bytes(dt, dims)

    # 1. multipliers: walk from entry through while ops
    mult: Dict[str, float] = defaultdict(float)
    if "__entry__" not in comps:
        raise ValueError("no ENTRY computation found in HLO text")
    entry_lines = comps["__entry__"]
    # identify the actual entry computation name to avoid double count
    entry_names = [n for n, ls in comps.items() if ls is entry_lines]
    real_entry = [n for n in entry_names if n != "__entry__"][0]
    mult[real_entry] = 1.0
    frontier = [real_entry]
    while frontier:
        cname = frontier.pop()
        cmult = mult[cname]
        for line in comps.get(cname, []):
            if " while(" not in line:
                continue
            wm = WHILE_ATTR_RE.search(line)
            if not wm:
                continue
            cond, body = wm.group(1), wm.group(2)
            trips = _trip_count(line, cond, comps)
            for sub, m_extra in ((body, trips), (cond, trips + 1)):
                if sub in comps:
                    mult[sub] += cmult * m_extra
                    frontier.append(sub)

    # 2. executed computations = those with a multiplier (fusion-called
    #    computations are charged at their call site, not walked).
    flops = 0.0
    nbytes = 0.0
    flash_bytes = 0.0
    by_opcode: Dict[str, float] = defaultdict(float)
    dot_ops: List[KernelOp] = []
    coll_ops: List[KernelOp] = []

    for cname, cmult in list(mult.items()):
        if cmult <= 0:
            continue
        for line in comps.get(cname, []):
            m = OP_RE.match(line)
            if not m:
                continue
            name, rhs = m.groups()
            opcode = _opcode_of(rhs)
            if opcode is None or opcode in FREE_OPS:
                continue
            if tpu_correct and opcode == "convert" \
                    and cvt_src.get(name) == "bf16":
                continue  # CPU dot-legalisation artifact: free on TPU
            # --- bytes: result + operands (kernel-boundary traffic) ---
            line_bytes = shape_bytes_of(name)
            for opn in _operand_names(rhs):
                line_bytes += shape_bytes_of(opn)
            nbytes += cmult * line_bytes
            by_opcode[opcode] += cmult * line_bytes
            if opcode in ("fusion", "dot"):
                rdt, rdims = sym.get(name, ("", []))
                if len(rdims) >= 3 and rdims[-1] == 512 and rdims[-2] >= 128:
                    flash_bytes += cmult * line_bytes

            # --- dot flops ---
            if opcode == "dot":
                attrs = rhs.split(")", 1)[1] if ")" in rhs else ""
                dims = {k: _parse_int_list(rx.search(attrs).group(1))
                        if rx.search(attrs) else []
                        for k, rx in DIMS_RE.items()}
                opnames = _operand_names(rhs)
                if len(opnames) >= 2 and opnames[0] in sym and opnames[1] in sym:
                    (ldt, ldims), (_, rdims2) = sym[opnames[0]], sym[opnames[1]]
                    b, mm, nn, kk = _mnk(ldims, rdims2, dims["lhs_b"],
                                         dims["lhs_c"], dims["rhs_b"],
                                         dims["rhs_c"])
                    op = KernelOp(kind="dot", opcode="dot", dtype=ldt,
                                  batch=b, m=mm, n=nn, k=kk, count=cmult,
                                  bytes=line_bytes)
                    dot_ops.append(op)
                    flops += cmult * op.flops

            # --- collectives ---
            for kind in COLLECTIVES:
                if opcode == kind or opcode == kind + "-start":
                    g = 1
                    gm = GROUPS_RE.search(line)
                    if gm:
                        g = int(gm.group(2))
                    else:
                        gl = GROUPS_LIST_RE.search(line)
                        if gl:
                            g = len([x for x in gl.group(1).split(",")
                                     if x.strip()])
                    # result shape: last tensor in the (possibly tuple) result
                    shapes = RESULT_SHAPES_RE.findall(rhs.split(opcode)[0])
                    if shapes:
                        cdt, cdims = shapes[-1]
                        cb = _shape_bytes(cdt, _parse_int_list(cdims))
                        ops_n = _operand_names(rhs)
                        if tpu_correct and cdt == "f32" and ops_n and \
                                cvt_src.get(ops_n[0]) == "bf16":
                            cb /= 2  # TPU moves the bf16 tensor, not f32
                        g = max(1, g)
                        coll_ops.append(KernelOp(
                            kind="collective", opcode=kind, count=cmult,
                            dtype=cdt, bytes=cb,
                            wire_bytes=_wire_bytes(kind, cb, g), group=g))
                    break

    # 3. memory-bound traffic, one aggregated op per opcode (dot and
    #    collective traffic already carried on their typed ops).
    coll_opcodes = {op.opcode for op in coll_ops} \
        | {op.opcode + "-start" for op in coll_ops}
    mem_ops = [KernelOp(kind="memory", opcode=opc, bytes=total)
               for opc, total in sorted(by_opcode.items(),
                                        key=lambda kv: -kv[1])
               if opc != "dot" and opc not in coll_opcodes]

    return KernelGraph(
        ops=dot_ops + coll_ops + mem_ops,
        flops=flops,
        bytes_accessed=nbytes,
        collective_wire=sum(op.count * op.wire_bytes for op in coll_ops),
        flash_block_bytes=flash_bytes,
        bytes_by_opcode=dict(by_opcode),
        key=graph_key(text),
        source="hlo",
    )
