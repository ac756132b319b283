"""Record what a run of a program executes: its row reads, sorts, gathers
and scatters, the storages it writes, and its peak memory.

The counterpart of the reference's ``analysis/jaxpr.py``, which walks a
traced jaxpr.  The port runs eagerly, so ``Recorder`` is a
``TorchDispatchMode`` that sees every aten op the program executes
(backward ops included) and counts under the reference's rules:

  * a **read** is an op with an operand of exactly ``row_elems`` elements
    (the row block being measured).  Layout and dtype plumbing is not a
    read: views, ``reshape``, ``expand``, ``permute``, ``slice``,
    ``_to_copy`` and other casts, ``clone`` (``LAYOUT_OPS``), as the
    reference leaves out ``LAYOUT_PRIMS``;
  * **sorts** (``SORT_OPS``), **gathers** and **scatters** are counted by
    their aten names wherever they run, whatever their operands' size;
  * **static sites, not executions.**  A jaxpr holds one eqn per op and
    call site, and a ``while`` body is one site however often it runs.
    So ``row_reads`` counts distinct read sites, a site being the op's
    name and the chain of source lines from it up to the frame that
    entered the recorder (torch's and the standard library's frames left
    out), and the count of executed reads is kept beside it as
    ``row_reads_executed``;
  * a **kernel call is ONE read and is not recursed**, as the reference's
    ``pallas_call``.  Every kernel wrapper runs its launch and its plain
    version inside ``kernels.build.kernel_scope(name, *inputs)``; the
    scope is a read (at the wrapper's call site) if one of its inputs has
    ``row_elems`` elements, and no op inside it is counted, so the card's
    launch and the CPU's plain version give the same counts.  Sorts
    inside a plain version are not the program's structure.

The recorder also keeps the storages the run writes in place (an op's
mutable arguments, for ``passes.check_in_place``) and its peak memory
(``memory``: the live-storage sweep, and the allocator's count where an
input lies on the card).
"""
from __future__ import annotations

import os
import sys
import weakref
from dataclasses import dataclass, field
from typing import (Any, Dict, FrozenSet, Iterator, List, Optional,
                    Sequence, Set)

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.comms import CollectiveOp
from repro_torch.analysis.memory import LiveSet, MemoryEstimate
from repro_torch.kernels import build

# layout / dtype plumbing (besides every op whose schema returns a view)
LAYOUT_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "permute", "slice", "select", "narrow", "t", "transpose",
    "squeeze", "unsqueeze", "flatten", "unflatten", "as_strided", "alias",
    "detach", "_to_copy", "to", "_to_dtype", "type_as", "clone", "copy",
    "contiguous", "lift_fresh", "lift_fresh_copy", "unbind", "split",
    "split_with_sizes", "chunk"})
SORT_OPS = frozenset({"sort", "topk", "kthvalue", "msort", "argsort"})
GATHER_OPS = frozenset({"gather", "index_select", "index", "take",
                        "take_along_dim", "embedding"})
SCATTER_OPS = frozenset({
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_put", "index_put_", "_index_put_impl_",
    "index_copy", "index_copy_", "index_add", "index_add_", "index_fill",
    "index_fill_", "masked_scatter", "masked_scatter_"})

_SKIP_DIRS = tuple(os.path.dirname(m.__file__) + os.sep
                   for m in (torch, os))
_SKIP_FILES = (__file__, build.__file__)


@dataclass
class Counts:
    """Op counts of one recorded run.

    reads           distinct row-read sites
    reads_executed  row reads as executed (a loop's every pass)
    sorts / gathers / scatters   ops of each class, as executed
    kernels         {name: calls} of every ``kernel_scope`` entered: on
                    the card each wrapper's call is one launch
    """
    reads: int = 0
    reads_executed: int = 0
    sorts: int = 0
    gathers: int = 0
    scatters: int = 0
    kernels: Dict[str, int] = field(default_factory=dict)


@dataclass
class Run:
    """What ``Contract.check`` measures a contract on: any part may be
    None where it was not recorded (a contract field that needs it is
    then a violation).

    counts     ``Counts`` of the run (``row_reads``/``sorts``)
    row_elems  the row-block size ``counts.reads`` was measured against
    ops        the collectives issued (``comms.CollectiveOp``; ``[]`` for
               a run without a mesh, which issues none)
    memory     the run's peak (``memory.MemoryEstimate``)
    in_place   positions of the program's arguments that held its result
               in place (``passes.in_place_positions``)
    """
    counts: Optional[Counts] = None
    row_elems: Optional[int] = None
    ops: Optional[Sequence[CollectiveOp]] = None
    memory: Optional[MemoryEstimate] = None
    in_place: Optional[FrozenSet[int]] = None


def tensors_in(obj: Any) -> Iterator[torch.Tensor]:
    """Every tensor held in ``obj``: itself, or inside tuples, lists, dicts
    and dataclass instances (the cohort's ``WidthMasks``)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from tensors_in(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from tensors_in(o)
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            yield from tensors_in(getattr(obj, name, None))


def _storage(t: torch.Tensor):
    return t.untyped_storage()


class Recorder(TorchDispatchMode):
    """Records one run of a program (see the module docstring)::

        with Recorder(row_elems=x.numel(), inputs=(x, q)) as rec:
            program(x, q)
        rec.counts, rec.memory, rec.written

    ``inputs``: what the program was given (tensors anywhere inside), live
    from the start of the sweep and resident for the allocator's count.
    ``sweep=False`` skips the storage sweep (the allocator's count
    remains on the card)."""

    def __init__(self, row_elems: Optional[int] = None, inputs: Any = (),
                 sweep: bool = True):
        super().__init__()
        self.row_elems = row_elems
        self.counts = Counts()
        self.written: Set[int] = set()
        self.sites: Set[tuple] = set()
        self._inputs = list({_storage(t)._cdata: t
                             for t in tensors_in(inputs)}.values())
        self._live = LiveSet() if sweep else None
        self._cuda = any(t.is_cuda for t in self._inputs)
        self._scope_depth = 0
        self._active = False
        self.allocator: Optional[MemoryEstimate] = None
        self.sweep: Optional[MemoryEstimate] = None

    # -- the recording window ---------------------------------------------

    def __enter__(self) -> "Recorder":
        self._root = sys._getframe(1)
        if self._live is not None:
            for i, t in enumerate(self._inputs):
                self._track(_storage(t), f"input[{i}]")
        if self._cuda:
            torch.cuda.synchronize()
            self._base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self._active = True
        build.SCOPE_HOOKS.append(self._scope)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        build.SCOPE_HOOKS.remove(self._scope)
        if self._cuda:
            torch.cuda.synchronize()
            held = sum(_storage(t).nbytes() for t in self._inputs)
            self.allocator = MemoryEstimate(
                torch.cuda.max_memory_allocated() - self._base + held, -1,
                (), "allocator")
        self._active = False
        self.sweep = None if self._live is None else self._live.estimate()
        self._root = None
        return out

    @property
    def memory(self) -> Optional[MemoryEstimate]:
        """The allocator's peak where the run was on the card, else the
        sweep's."""
        return self.allocator or self.sweep

    def run(self, **kw) -> Run:
        """This recording as a ``Run`` (``ops``, ``in_place`` given)."""
        return Run(counts=self.counts, row_elems=self.row_elems,
                   memory=self.memory, **kw)

    # -- sites ------------------------------------------------------------

    def _site(self) -> tuple:
        """The chain of (file, line) from the current op up to the frame
        that entered the recorder, torch's and the standard library's
        frames and this module's left out."""
        out: List[tuple] = []
        f = sys._getframe(1)
        while f is not None:
            fn = f.f_code.co_filename
            if fn not in _SKIP_FILES and not fn.startswith(_SKIP_DIRS):
                out.append((fn, f.f_lineno))
            if f is self._root:
                break
            f = f.f_back
        return tuple(out)

    def _read(self, name: str) -> None:
        self.counts.reads_executed += 1
        site = (name,) + self._site()
        if site not in self.sites:
            self.sites.add(site)
            self.counts.reads += 1

    def _rowsized(self, tensors) -> bool:
        return any(t.numel() == self.row_elems for t in tensors)

    # -- kernels -----------------------------------------------------------

    def _scope(self, name: str, inputs, writes=()):
        return _Scope(self, name, inputs, writes)

    # -- storages ----------------------------------------------------------

    def _track(self, st, name: str) -> None:
        nbytes = st.nbytes()
        if nbytes == 0:
            return
        key = st._cdata
        self._live.charge(key, name, nbytes)
        weakref.finalize(st, self._live.free, key)

    # -- every op ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._active:
            return out
        op = _op_info(func)
        if self._scope_depth == 0:
            if op.klass:
                setattr(self.counts, op.klass,
                        getattr(self.counts, op.klass) + 1)
            if op.reads and self.row_elems is not None and self._rowsized(
                    a for a in tree_flatten((args, kwargs))[0]
                    if isinstance(a, torch.Tensor)):
                self._read(op.name)
            for i, key in op.writes:
                self._mark(args[i] if i < len(args) else kwargs.get(key))
        if self._live is not None and op.makes_storage:
            self._live.index += 1
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self._track(_storage(t), op.label)
        return out

    def _mark(self, val) -> None:
        for t in tensors_in(val):
            self.written.add(_storage(t).data_ptr())


@dataclass(frozen=True)
class _OpInfo:
    """What the recorder needs of an op, read once from its schema."""
    name: str
    label: str
    klass: Optional[str]     # "sorts" / "gathers" / "scatters" or None
    reads: bool              # may be a row read (not layout plumbing)
    makes_storage: bool      # returns fresh storage (no view, no alias)
    writes: tuple            # (position, name) of each argument it writes


_OP_INFO: Dict[Any, _OpInfo] = {}


def _op_info(func) -> _OpInfo:
    info = _OP_INFO.get(func)
    if info is None:
        schema = func._schema
        name = func.overloadpacket.__name__
        # c10d's collectives write their first argument and declare no
        # aliasing: they make no storage
        c10d = func.namespace == "c10d"
        aliased = c10d or any(r.alias_info is not None
                              for r in schema.returns)
        if c10d:
            writes = ((0, None),) if name.endswith("_") else ()
        else:
            writes = tuple((i, a.name) for i, a in enumerate(schema.arguments)
                           if a.alias_info is not None
                           and a.alias_info.is_write)
        klass = ("sorts" if name in SORT_OPS else "gathers"
                 if name in GATHER_OPS else "scatters"
                 if name in SCATTER_OPS else None)
        info = _OP_INFO[func] = _OpInfo(
            name, f"aten.{name}", klass,
            (not aliased or bool(writes)) and name not in LAYOUT_OPS,
            not aliased, writes)
    return info


class _Scope:
    """A kernel call inside a recording: one read at its call site if an
    input is row-sized, the tensors it writes in place marked written,
    nothing inside counted, its transients not charged."""

    def __init__(self, rec: Recorder, name: str, inputs, writes=()):
        self.rec, self.name, self.inputs = rec, name, inputs
        self.writes = writes

    def __enter__(self):
        rec = self.rec
        kernels = rec.counts.kernels
        kernels[self.name] = kernels.get(self.name, 0) + 1
        if rec._scope_depth == 0 and rec.row_elems is not None \
                and rec._rowsized(
                [t for t in self.inputs if isinstance(t, torch.Tensor)]):
            rec._read(self.name)
        if rec._scope_depth == 0:
            rec._mark(self.writes)
        rec._scope_depth += 1
        if rec._live is not None:
            rec._live.open_scope()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec._scope_depth -= 1
        if rec._live is not None:
            rec._live.close_scope()
        return False


def trace_counts(fn, *args, row_elems: Optional[int] = None,
                 **kwargs) -> Counts:
    """Run ``fn(*args, **kwargs)`` under a ``Recorder`` and return its
    counts."""
    with Recorder(row_elems=row_elems, inputs=(args, kwargs),
                  sweep=False) as rec:
        fn(*args, **kwargs)
    return rec.counts
