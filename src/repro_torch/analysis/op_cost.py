"""Op-level cost counter of one rank's torch program: the port of
``repro.analysis.hlo_cost``.

The reference re-derives FLOPs and bytes from the partitioned HLO text and
multiplies loop bodies by their trip counts. The port's programs are eager
PyTorch, whose Python loops (layers, microbatches, attention chunks,
remat's recompute in the backward) issue every op they run, so
:class:`OpCounter`, a ``TorchDispatchMode``, counts each aten op as it is
dispatched, on the card or on ``meta`` tensors (shapes only: nothing is
computed or allocated). The reference's rules:

* a matrix product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  ``dot``: what ``@``, ``matmul`` and ``layers.matmul_f32`` reach) counts
  2 x result elements x contracted extent, kept by operand type as well
  (the roofline prices each type at its own peak);
* an elementwise op counts 1 an element of its result, and a
  transcendental one (``exp``, ``log``, ``tanh``, ``rsqrt``, ``silu``, ...)
  counts its elements among the transcendentals too;
* a reduction (``sum``, ``amax``, ``logsumexp``, ``cumsum``, softmax)
  counts the elements of its input;
* views and metadata ops (an op that writes nothing and whose results all
  share an input's storage) and bare allocations count zero bytes;
* copies and casts (``clone``, ``_to_copy``, ``copy_``) move bytes and
  count no FLOPs.

Bytes are each op's tensor operands plus its results, every tensor at its
own extent (a view at the view's size); ``copy_``, ``fill_`` and ``zero_``
do not read the tensor they overwrite. Eager PyTorch fuses nothing, so
that is the traffic the program really makes. It differs by design from
the reference's count at XLA's fusion boundaries (a fused chain of
elementwise ops is charged there once, here op by op) and from its rule
that converts are free.

Collectives come from the grid, not from the dispatcher: a
:class:`~repro_torch.launch.mesh.DeviceGrid` records each one it issues
(``grid.records``), and the counter takes the records made while it was
entered (wire bytes by the ring formulas of
:mod:`repro_torch.analysis.collectives`, HBM bytes operand plus result).
The process group's own ops (the ``c10d`` namespace) are left out, so a
real rank and a rankless one count the same.

On ``meta`` tensors most of the time would go to the meta kernels, many
of which are Python decompositions: an op that writes no input and
returns fresh tensors is run once for each signature (the tensors'
shapes, strides and types and the other arguments), and later calls make
fresh ``meta`` tensors of the same layout without running it.

Live memory: every storage an op creates is tracked, keyed by the storage
itself (a storage's Python object is unique while the storage lives) and
released by a weak reference's callback when it dies. With the
arguments' storages registered on entry, :meth:`OpCounter.memory` gives
the reference's ``memory_analysis`` fields.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot"}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos", "tan", "erf", "atan2",
    "silu", "silu_backward", "gelu", "gelu_backward", "softplus",
    "softplus_backward", "_softmax", "_log_softmax", "logsumexp",
}
_REDUCTION = {"_softmax", "_log_softmax", "_softmax_backward_data",
              "_log_softmax_backward_data", "cumsum", "cumprod"}
_NO_FLOPS = {"clone", "_to_copy", "copy_", "lift_fresh_copy"}
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted"}
_OVERWRITE = {"copy_", "fill_", "zero_"}
_SKIP_NAMESPACES = {"c10d", "_c10d_functional", "_dtensor"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _scan(x, ts: list):
    """(a hashable key of an op's argument ``x``: tensors by layout, the
    rest by value), appending its tensors to ``ts``."""
    if isinstance(x, torch.Tensor):
        ts.append(x)
        return (x.shape, x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple([_scan(v, ts) for v in x])
    if isinstance(x, dict):
        return tuple([(k, _scan(v, ts)) for k, v in x.items()])
    return x


def _on_meta(ins: list, kwargs: dict) -> bool:
    """Whether an op runs on ``meta``: its tensors, or a factory's device."""
    if ins:
        return all(t.is_meta for t in ins)
    dev = kwargs.get("device")
    return dev is not None and torch.device(dev).type == "meta"


def _fresh(layout) -> torch.Tensor:
    shape, stride, dtype = layout
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _shape(key) -> str:
    dtype, shape = key
    return f"{str(dtype).replace('torch.', '')}[{','.join(map(str, shape))}]"


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    wire_bytes: float = 0.0          # collective traffic per rank
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    matmul_flops: dict = dataclasses.field(default_factory=dict)  # by dtype
    wire_by_ring: dict = dataclasses.field(default_factory=dict)  # ranks


class _Kind:
    """How one op overload is counted (cached per overload)."""

    __slots__ = ("name", "skip", "matmul", "pointwise", "reduction",
                 "transcendental", "alloc", "overwrite", "mutable")

    def __init__(self, func):
        name = func.overloadpacket.__name__
        base = name.rstrip("_")
        tags = set(func.tags)
        self.name = name
        self.skip = func.namespace in _SKIP_NAMESPACES
        self.matmul = name in _MATMUL
        self.pointwise = (torch.Tag.pointwise in tags
                          and name not in _NO_FLOPS)
        if name.endswith("_") and name not in _NO_FLOPS | _OVERWRITE:
            # an in-place op counts as its functional form
            functional = getattr(torch.ops.aten, base, None)
            if functional is not None and any(
                    torch.Tag.pointwise in getattr(functional, o).tags
                    for o in functional.overloads()):
                self.pointwise = True
        self.reduction = (torch.Tag.reduction in tags or name in _REDUCTION)
        self.transcendental = base in _TRANSCENDENTAL
        self.alloc = name in _ALLOC
        self.overwrite = name in _OVERWRITE
        self.mutable = func._schema.is_mutable


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes and live storage of every aten op run while
    it is entered.

    ``args``: the program's arguments (a tree of tensors), whose storages
    are this rank's argument bytes; ``records``: the list a grid appends
    its collectives to (``grid.records``), or None.
    """

    def __init__(self, args=(), records=None):
        super().__init__()
        self._records = records
        self._span = [0, None]         # the records made while entered
        self._lock = threading.RLock()
        self._kinds: dict = {}
        self._memo: dict = {}          # meta signature -> output layouts
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.matmul_flops: dict = {}
        self.per_op: dict = {}        # name -> [count, flops, bytes]
        self._rows: dict = {}         # (name, result shape) -> row
        # live storage: storage key -> bytes, argument storages apart
        self._args = {}
        for t in _tensors(args, []):
            st = t.untyped_storage()
            self._args[st._cdata] = st.nbytes()
        self.argument_bytes = sum(self._args.values())
        self._live: dict = {}
        self._refs: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def __enter__(self):
        self._span = [len(self._records or ()), None]
        return super().__enter__()

    def __exit__(self, *exc):
        self._span[1] = len(self._records or ())
        return super().__exit__(*exc)

    # -- live storage --------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._args:
            return
        n = st.nbytes()
        self._live[key] = n
        self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key) -> None:
        with self._lock:
            n = self._live.pop(key, None)
            self._refs.pop(key, None)
            if n is not None:
                self.live_bytes -= n

    # -- counting ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _Kind(func)
        if kind.skip:
            return func(*args, **kwargs)
        ins: list = []
        sig = (_scan(args, ins), _scan(kwargs, ins))
        key = hit = None
        if _on_meta(ins, kwargs):
            key = (func, sig)
            try:
                hit = self._memo.get(key)
            except TypeError:          # an unhashable argument
                key = None
        if hit is not None:
            layouts, tally = hit
            if layouts is None:
                out = func(*args, **kwargs)
            elif isinstance(layouts, list):
                out = tuple(map(_fresh, layouts))
            else:
                out = _fresh(layouts)
        else:
            out = func(*args, **kwargs)
            tally = self._tally(kind, ins, _tensors(out, []))
            if key is not None:
                self._memo[key] = (self._fresh_layouts(kind, ins, out),
                                   tally)
        with self._lock:
            self._add(kind, tally)
            for t in _tensors(out, []):
                self._track(t)
        return out

    @staticmethod
    def _fresh_layouts(kind: _Kind, ins: list, out):
        """The output layouts of an op that writes no input and returns
        only fresh tensors (it need not run again on ``meta``), else None."""
        if kind.mutable:
            return None
        outs = (out,) if isinstance(out, torch.Tensor) else out
        if not isinstance(outs, tuple) or not outs:
            return None
        stores = {t.untyped_storage()._cdata for t in ins}
        if not all(isinstance(t, torch.Tensor) and t.storage_offset() == 0
                   and t.untyped_storage()._cdata not in stores
                   for t in outs):
            return None
        layouts = [(tuple(t.shape), t.stride(), t.dtype) for t in outs]
        return layouts[0] if isinstance(out, torch.Tensor) else layouts

    @staticmethod
    def _tally(kind: _Kind, ins: list, outs: list) -> tuple:
        """(FLOPs, bytes, transcendentals, matmul operand type, breakdown
        row key) of one op."""
        flops = trans = 0.0
        nbytes = 0
        mm = None
        if kind.alloc:
            pass
        elif not kind.mutable and outs and all(
                any(o.untyped_storage()._cdata == i.untyped_storage()._cdata
                    for i in ins) for o in outs):
            pass                       # a view or a metadata op
        else:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            if kind.overwrite and ins:
                nbytes -= _nbytes(ins[0])
            if kind.matmul:
                a = ins[1] if kind.name in ("addmm", "baddbmm") else ins[0]
                flops = 2.0 * outs[0].numel() * a.shape[-1]
                mm = _dtype(a)
            elif kind.reduction:
                flops = float(ins[0].numel()) if ins else 0.0
            elif kind.pointwise and outs:
                flops = float(outs[0].numel())
            if kind.transcendental:
                trans = float(ins[0].numel() if kind.reduction
                              else outs[0].numel() if outs else 0)
        row = (kind.name, (outs[0].dtype, tuple(outs[0].shape))
               if outs else None)
        return flops, nbytes, trans, mm, row

    def _add(self, kind: _Kind, tally: tuple) -> None:
        flops, nbytes, trans, mm, row_key = tally
        self.flops += flops
        self.bytes += nbytes
        self.transcendentals += trans
        if mm is not None:
            self.matmul_flops[mm] = self.matmul_flops.get(mm, 0.0) + flops
        op = self.per_op.setdefault(kind.name, [0, 0.0, 0])
        op[0] += 1
        op[1] += flops
        op[2] += nbytes
        row = self._rows.setdefault(
            row_key, {"flops": 0.0, "bytes": 0.0, "wire": 0.0, "count": 0})
        row["flops"] += flops
        row["bytes"] += nbytes
        row["count"] += 1

    # -- results -------------------------------------------------------------

    @property
    def collectives(self) -> list:
        """The grid's collectives issued while the counter was entered."""
        return list((self._records or [])[self._span[0]:self._span[1]])

    def cost(self) -> Cost:
        c = Cost(self.flops, self.bytes, self.transcendentals,
                 matmul_flops=dict(self.matmul_flops))
        for coll in self.collectives:
            w = coll.wire_bytes
            c.bytes += coll.operand_bytes + coll.result_bytes
            c.wire_bytes += w
            c.coll_by_kind[coll.kind] = c.coll_by_kind.get(coll.kind, 0.0) + w
            c.wire_by_ring[coll.ranks] = \
                c.wire_by_ring.get(coll.ranks, 0.0) + w
        return c

    def memory(self, outputs) -> dict:
        """The reference's ``memory_analysis`` fields in GB: arguments (this
        rank's state blocks and batch rows), outputs, aliased outputs (an
        argument's storage, as decode's caches updated in place), temp
        (the peak of live bytes beyond the arguments, less the fresh
        outputs) and peak = arguments + outputs + temp - aliased."""
        seen = {}
        for t in _tensors(outputs, []):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
        out_b = sum(seen.values())
        alias_b = sum(n for k, n in seen.items() if k in self._args)
        temp_b = max(self.peak_bytes - (out_b - alias_b), 0)
        return {"argument_gb": self.argument_bytes / 1e9,
                "output_gb": out_b / 1e9,
                "temp_gb": temp_b / 1e9,
                "alias_gb": alias_b / 1e9,
                "peak_gb": (self.argument_bytes + out_b + temp_b
                            - alias_b) / 1e9}

    def breakdown(self, top=20) -> list:
        """The ``top`` (op, result shape) rows by bytes (all of them for
        None): op, bytes, flops, wire, count, shape; collectives as rows of
        their kind."""
        rows = {(name, _shape(key) if key else ""): dict(v)
                for (name, key), v in self._rows.items()}
        for coll in self.collectives:
            row = rows.setdefault(
                (coll.kind, f"{coll.result_bytes} B, ring {coll.group_size}"),
                {"flops": 0.0, "bytes": 0.0, "wire": 0.0, "count": 0})
            row["bytes"] += coll.operand_bytes + coll.result_bytes
            row["wire"] += coll.wire_bytes
            row["count"] += 1
        out = [{"op": k[0], "shape": k[1], **v} for k, v in rows.items()]
        out.sort(key=lambda r: -r["bytes"])
        return out if top is None else out[:top]


def count(fn, *args, records=None):
    """Run ``fn(*args)`` under an :class:`OpCounter` whose arguments are
    ``args``; returns (its result, the counter)."""
    counter = OpCounter(args, records)
    with counter:
        result = fn(*args)
    return result, counter
