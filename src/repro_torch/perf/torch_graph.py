"""The port's graph source: a PyTorch function -> :class:`KernelGraph`.

The reference prices a model by lowering it through XLA
(``jax.jit(f).lower(...).compile().as_text()``) and parsing the HLO text
(:func:`repro_torch.perf.hlo_ir.parse_module`).  The port's counterpart
is :func:`capture`: it runs the function once under a
``TorchDispatchMode`` that records every aten op, with parameters and
inputs on the ``meta`` device, so a full-width model costs no memory,
no card and no arithmetic.  What it records is the plain path
(``use_kernels=False``: ``loss_fn``, ``prefill``, ``decode_step``), as
the reference's lowering is of its ``use_pallas=False`` path; the kernel
wrappers launch through ``ctypes`` and are invisible to the dispatcher.
On the meta device :func:`repro_torch.models.layers.mm` takes the card's
route (bf16 operands straight to the product), so the graph holds the
products the card runs.

Counting rules:

* **Dots.**  ``mm``, ``bmm``, ``addmm`` and ``baddbmm`` (any overload:
  ``mm.dtype`` is the f32-output product) become ``KernelOp(kind="dot")``
  with ``batch``, ``m``, ``n``, ``k`` and the operands' HLO dtype name
  (:data:`~repro_torch.perf.hlo_ir.BYTES_PER_ELEM`'s keys); ``matmul``
  and ``einsum`` reach the dispatcher as these.  A product of two exact
  upcasts of one narrower dtype (``_to_copy`` from bf16 to f32, through
  any views and copies) is recorded in that dtype, as
  ``parse_module(tpu_correct=True)`` treats XLA:CPU's upcast converts: a
  matrix unit takes the narrow operands and accumulates in f32.
  Identical sites merge, ``count`` the number of calls, so a 28-layer
  Python loop gives one op of count 28, as a scanned HLO loop does.
* **Bytes.**  Every op's distinct input tensors plus its outputs (an
  in-place result counted once; a broadcast (stride-0) dim not
  multiplied), summed into ``bytes_accessed``, per aten opcode into
  ``bytes_by_opcode``, and into one ``kind="memory"`` op per non-dot
  opcode, as ``parse_module`` does.  A gather (``index``,
  ``index_select``, ``embedding``, ``gather``) reads its source at the
  size it writes; a scatter (``index_put_``, ``index_copy_``,
  ``scatter_``) writes its destination at the size of its values
  without reading it.  Views, reshapes, ``arange`` (HLO's ``iota``),
  ``empty`` and other metadata-only ops are free, as
  :data:`~repro_torch.perf.hlo_ir.FREE_OPS` makes them for HLO.
* **``flash_block_bytes``.**  Every byte the plain attention core
  (``models.attention``'s ``attention``, ``sdpa``, ``_flash_sdpa``)
  moves beyond reading its tensor arguments and writing its output
  once: the scores and probabilities and their masked, upcast and
  head-repeated copies, all of which the flash and decode kernels keep
  on chip.  So ``RooflineEngine(kernel_adjusted=True)`` prices the
  kernel path, as the reference's does for its Pallas kernel.
* No collectives, ``source="torch"``, and ``key`` a hash of the
  recorded ops.

While :func:`capture` runs, the attention core's functions in
``repro_torch.models.attention`` are wrapped to mark that region; one
capture at a time (it is not thread safe).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
from collections import OrderedDict, defaultdict
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.perf.hlo_ir import KernelGraph, KernelOp

__all__ = ["capture", "meta_params", "meta_cache", "meta_tokens",
           "ON_CHIP"]

_aten = torch.ops.aten

#: torch dtype -> the HLO name of the shared byte table.
_HLO_NAMES = {"float64": "f64", "float32": "f32", "bfloat16": "bf16",
              "float16": "f16", "float8_e4m3fn": "f8e4m3fn",
              "float8_e5m2": "f8e5m2", "int64": "s64", "int32": "s32",
              "int16": "s16", "int8": "s8", "uint64": "u64", "uint32": "u32",
              "uint16": "u16", "uint8": "u8", "bool": "pred"}

#: The products: aten overload packet -> positions of (lhs, rhs).
_DOTS = {_aten.mm: (0, 1), _aten.bmm: (0, 1), _aten.addmm: (1, 2),
         _aten.baddbmm: (1, 2)}
_GATHERS = {_aten.index, _aten.index_select, _aten.embedding, _aten.gather}
_SCATTERS = {_aten.index_put_, _aten.index_copy_, _aten.scatter_}
#: Metadata-only ops besides the schema's views.
_FREE = {_aten._unsafe_view, _aten.arange, _aten.empty, _aten.empty_like,
         _aten.empty_strided, _aten.lift_fresh, _aten.lift_fresh_copy,
         _aten.detach, _aten.alias, _aten.scalar_tensor,
         _aten._local_scalar_dense, _aten.sym_size, _aten.sym_stride,
         _aten.sym_numel, _aten.sym_storage_offset}
#: Ops that carry an exact upcast's mark to their output.
_KEEPS_UPCAST = {_aten._unsafe_view, _aten.clone, _aten.alias,
                 _aten.detach}

#: The plain attention core whose intermediates the kernels keep on chip:
#: module -> function names (see the module docstring).
ON_CHIP = {"repro_torch.models.attention": ("attention", "sdpa",
                                            "_flash_sdpa")}


def _hlo_dtype(dtype: torch.dtype) -> str:
    """The HLO name of a torch dtype (``torch.bfloat16`` -> ``"bf16"``)."""
    name = str(dtype).replace("torch.", "")
    return _HLO_NAMES.get(name, name)


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's stored elements times its element size: a broadcast
    (stride-0) dim is read once, not once per index.  A DTensor counts
    its local block (what one device holds)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The distinct tensors in a pytree, by identity, in order."""
    seen: "OrderedDict[int, torch.Tensor]" = OrderedDict()
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            seen.setdefault(id(x), x)
    return list(seen.values())


@dataclasses.dataclass
class _Site:
    op: KernelOp
    count: int = 0


class _Recorder(TorchDispatchMode):
    """Records every aten op: dot sites, per-opcode bytes, and the bytes
    moved inside the marked on-chip regions."""

    def __init__(self):
        super().__init__()
        self.dots: "OrderedDict[Tuple, _Site]" = OrderedDict()
        self.by_opcode: Dict[str, float] = defaultdict(float)
        self.total = 0.0
        self.flash = 0.0
        self.depth = 0
        self.upcast = WeakIdKeyDictionary()   # tensor -> narrow source dtype

    # -- what one op moves ------------------------------------------------
    def _bytes(self, packet, args, kwargs, out) -> float:
        ins = _tensors((args, kwargs))
        outs = [t for t in _tensors(out) if all(t is not i for i in ins)]
        if packet in _GATHERS:
            # the source is read at the size written, plus the indices
            src = args[0]
            return (sum(_nbytes(t) for t in ins if t is not src)
                    + 2 * sum(_nbytes(t) for t in outs))
        if packet in _SCATTERS:
            dst = args[0]
            rest = [t for t in ins if t is not dst]
            values = rest[-1] if rest else dst
            return sum(_nbytes(t) for t in rest) + _nbytes(values)
        return (sum(_nbytes(t) for t in ins)
                + sum(_nbytes(t) for t in outs))

    def _dot_dtype(self, a: torch.Tensor, b: torch.Tensor) -> str:
        src_a, src_b = self.upcast.get(a), self.upcast.get(b)
        if src_a is not None and src_a == src_b:
            return _hlo_dtype(src_a)
        return _hlo_dtype(a.dtype)

    def _mark_upcasts(self, func, packet, args, kwargs, out) -> None:
        if not isinstance(out, torch.Tensor) or not args \
                or not isinstance(args[0], torch.Tensor):
            return
        src = args[0]
        widened = (src.dtype.is_floating_point
                   and out.dtype.is_floating_point
                   and src.element_size() < out.element_size())
        if packet is _aten._to_copy and widened:
            self.upcast[out] = self.upcast.get(src, src.dtype)
        elif (func.is_view or packet in _KEEPS_UPCAST) and src in self.upcast:
            self.upcast[out] = self.upcast[src]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        self._mark_upcasts(func, packet, args, kwargs, out)
        if func.is_view or packet in _FREE:
            return out
        nbytes = float(self._bytes(packet, args, kwargs, out))
        name = packet.__name__
        self.total += nbytes
        self.by_opcode[name] += nbytes
        if packet in _DOTS:
            ia, ib = _DOTS[packet]
            a, b = args[ia], args[ib]
            if a.dim() == 2:
                batch, (m, k), n = 1, a.shape, b.shape[-1]
            else:
                batch, m, k, n = a.shape[0], a.shape[1], a.shape[2], \
                    b.shape[-1]
            op = KernelOp(kind="dot", opcode=name,
                          dtype=self._dot_dtype(a, b), batch=int(batch),
                          m=int(m), n=int(n), k=int(k), bytes=nbytes)
            key = (op.opcode, op.dtype, op.batch, op.m, op.n, op.k, nbytes)
            self.dots.setdefault(key, _Site(op)).count += 1
        return out

    # -- the on-chip regions ------------------------------------------------
    def region(self, fn: Callable) -> Callable:
        """``fn`` wrapped to charge what it moves beyond its tensor
        arguments and its output to ``flash`` (outermost call only)."""
        def wrapped(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            self.depth += 1
            before = self.total
            try:
                out = fn(*args, **kwargs)
            finally:
                self.depth -= 1
            io = sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
            self.flash += max(0.0, self.total - before - io)
            return out
        return wrapped

    def graph(self) -> KernelGraph:
        dots = [dataclasses.replace(s.op, count=float(s.count))
                for s in self.dots.values()]
        dot_names = {packet.__name__ for packet in _DOTS}
        mem = [KernelOp(kind="memory", opcode=name, bytes=total)
               for name, total in sorted(self.by_opcode.items(),
                                         key=lambda kv: -kv[1])
               if name not in dot_names]
        ops = dots + mem
        flops = float(sum(op.count * op.flops for op in dots))
        digest = hashlib.sha256(repr(
            (ops, flops, self.total, self.flash)).encode()).hexdigest()[:16]
        return KernelGraph(ops=ops, flops=flops, bytes_accessed=self.total,
                           collective_wire=0.0, flash_block_bytes=self.flash,
                           bytes_by_opcode=dict(self.by_opcode), key=digest,
                           source="torch")


@contextlib.contextmanager
def _on_chip_regions(rec: _Recorder):
    saved: List[Tuple[object, str, Callable]] = []
    try:
        for mod_name, names in ON_CHIP.items():
            mod = importlib.import_module(mod_name)
            for name in names:
                fn = getattr(mod, name)
                saved.append((mod, name, fn))
                setattr(mod, name, rec.region(fn))
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def capture(fn: Callable, *args, **kwargs) -> KernelGraph:
    """Run ``fn(*args, **kwargs)`` once, without grad, recording its aten
    ops, and return them as a :class:`KernelGraph` (``source="torch"``).

    Pass tensors on the ``meta`` device (:func:`meta_params`,
    :func:`meta_cache`, :func:`meta_tokens`) to price a full-width model
    for nothing.  CPU tensors work too: the function then really runs,
    and ``layers.mm``'s f32 upcasts of bf16 products add their bytes
    (the products are recorded in bf16 all the same).  The function must
    not read tensor values (``.item()``, ``.tolist()``), which meta
    tensors do not have.

    >>> cfg = dataclasses.replace(get_config("qwen2-7b"), use_kernels=False)
    >>> graph = capture(prefill, cfg, meta_params(cfg),
    ...                 {"tokens": meta_tokens((1, 2048))}, 2048)
    >>> predict(graph, device="h100", engine="roofline")
    """
    rec = _Recorder()
    with torch.no_grad(), _on_chip_regions(rec), rec:
        fn(*args, **kwargs)
    return rec.graph()


def _meta_like(tree):
    """A pytree of tensors as meta tensors of the same shapes and dtypes
    (other leaves kept)."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
        return x
    return tree_map(one, tree)


def _fake(make: Callable):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = make()
    return _meta_like(tree)


def meta_params(cfg) -> Dict:
    """``init_params(cfg)``'s tree on the meta device: the shapes and
    dtypes, no values, no memory (built under a ``FakeTensorMode``)."""
    from repro_torch.models import init_params
    return _fake(lambda: init_params(cfg, torch.Generator(), device="cpu"))


def meta_cache(cfg, batch: int, max_len: int, **kwargs) -> List[Dict]:
    """``init_cache(cfg, batch, max_len)``'s cache on the meta device."""
    from repro_torch.models import init_cache
    return _fake(lambda: init_cache(cfg, batch, max_len, device="cpu",
                                    **kwargs))


def meta_tokens(shape: Iterable[int]) -> torch.Tensor:
    """An int32 token tensor of ``shape`` on the meta device."""
    return torch.empty(tuple(shape), dtype=torch.int32, device="meta")
