"""Program recording: the port's counterpart of tracing a step to a jaxpr.

This module has no counterpart in the JAX package.  There the auditor
reads a jaxpr; an eager PyTorch step has none, and its collectives are
plain Python functions over the ``[P, W]`` replica axes
(``parallel/collectives.py``) that a dozen modules import by name.  So
the port runs the program once and records it: :func:`record_program`
returns a :class:`ProgramRecord`, the ordered stream of two kinds of
events, in the order they ran (the walk order):

- each collective call, through the collectives' recorder slot
  (``collectives.set_recorder``): the primitive the JAX function traces
  to, the axis, the operand's per-replica shape and dtype (without the
  leading ``[P, W]``, or ``[S]`` for the sp helpers, the per-device
  shape a jaxpr carries), the axis size and the routing (``perm``);
- each ATen op, from a ``TorchDispatchMode``: the op, its input dtypes
  and its output shapes.

Every event is an :class:`OpSite`, the ``EqnSite`` counterpart: its
``path`` is the stack of enclosing ``record_function`` scopes (the
profiler's enter/exit ops pass through the dispatch mode, so the stack
costs nothing extra) and :meth:`OpSite.source` the first ``file:line``
outside torch and this package's plumbing, taken only while recording.

The hand-written CUDA kernels (``ops/_build.py``) are pybind calls: no
dispatch mode sees them, so they never enter the record and are opaque
to every pass, as ``pallas_call`` is to the JAX walker.  The ATen ops
their wrappers make (the output allocations) do enter it.

A densifying op (scatter, index_add, index_put and their in-place
forms) also carries the identity of the buffer it writes: the recorder
holds that buffer's storage until the recording ends, so two buffers
never share an identity, and an in-place fold of runs into one buffer
reads as one materialization (``passes.PurityPass``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from geomx_tpu_torch.parallel import collectives

Sig = Tuple[Tuple[int, ...], str]  # (shape, dtype name)

# ATen ops that write a dense buffer from a sparse stream; in-place forms
# end in "_"
DENSIFY_OPS = frozenset({"scatter", "scatter_add", "index_add",
                         "index_put"})

_PROFILER_ENTER = "_record_function_enter_new"
_PROFILER_EXIT = "_record_function_exit"
_TORCH_DIR = os.path.dirname(torch.__file__)
_SKIP_FILES = frozenset({os.path.abspath(__file__),
                         os.path.abspath(collectives.__file__).replace(
                             ".pyc", ".py")})


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the JAX aval dtype spelling)."""
    return str(dtype).replace("torch.", "")


def sig_bytes(sig: Sig) -> int:
    """Bytes of one ``(shape, dtype)`` signature."""
    shape, dtype = sig
    try:
        item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    except (AttributeError, TypeError):
        return 0
    return math.prod(shape) * item


def tensor_sig(t: torch.Tensor, lead: int = 0) -> Sig:
    """``(shape, dtype)`` of ``t`` without its ``lead`` leading dims."""
    return (tuple(int(d) for d in t.shape[lead:]), dtype_name(t.dtype))


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One recorded event with its provenance (the ``EqnSite``
    counterpart).

    ``kind`` is ``"collective"`` or ``"aten"``.  ``primitive``: the JAX
    primitive a collective traces to, or an ATen op's name without its
    namespace and overload (``"scatter_add_"``); ``op`` the full ATen
    name (``"aten.scatter_add_.default"``).  ``operands``/``outputs``:
    ``(shape, dtype)`` pairs — per replica for a collective's operand,
    whole tensors for an ATen op.  ``buffers``: a densifying op's
    output buffer ids (module docstring)."""

    primitive: str
    index: int
    path: str = ""
    kind: str = "aten"
    op: str = ""
    axes: Tuple[str, ...] = ()
    operands: Tuple[Sig, ...] = ()
    outputs: Tuple[Sig, ...] = ()
    extras: tuple = ()
    axis_size: Optional[int] = None
    buffers: Tuple[int, ...] = ()
    origin: str = ""

    def source(self) -> str:
        """The ``file:line`` that made the call (empty if none outside
        torch and the recorder was found)."""
        return self.origin


@dataclasses.dataclass(frozen=True)
class ProgramRecord:
    """The events of one recorded run, in walk order."""

    events: Tuple[OpSite, ...]

    def ops(self) -> List[Tuple[str, str]]:
        """``(op, path)`` of every ATen event, in order."""
        return [(e.op, e.path) for e in self.events if e.kind == "aten"]

    def collectives(self) -> List[OpSite]:
        return [e for e in self.events if e.kind == "collective"]


def _caller() -> str:
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if not name.startswith(_TORCH_DIR) and name not in _SKIP_FILES:
            return f"{name}:{f.f_lineno}"
        f = f.f_back
    return ""


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)


class _Recorder(TorchDispatchMode):
    """The dispatch mode and the collectives' recorder, one event list."""

    def __init__(self):
        super().__init__()
        self.events: List[OpSite] = []
        self.scopes: List[str] = []
        self._held: dict = {}   # storage data_ptr -> (buffer id, storage)

    def _path(self) -> str:
        return "/".join(self.scopes)

    def collective(self, op, axis, x, lead, extras):
        self.events.append(OpSite(
            primitive=op, index=len(self.events), path=self._path(),
            kind="collective", op=op, axes=(str(axis),),
            operands=(tensor_sig(x, lead),),
            outputs=(), extras=tuple(extras),
            axis_size=int(x.shape[collectives.axis_dim(axis)])
            if lead == 2 else int(x.shape[0]), origin=_caller()))

    def _buffer(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st.data_ptr()
        got = self._held.get(key)
        if got is None:
            got = self._held[key] = (len(self._held), st)
        return got[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__.split(".")[0]
        if name == _PROFILER_ENTER:
            self.scopes.append(str(args[0]))
        out = func(*args, **kwargs)
        if name == _PROFILER_EXIT:
            if self.scopes:
                self.scopes.pop()
            return out
        if name == _PROFILER_ENTER:
            return out
        outs = tuple(_tensors(out))
        buffers = tuple(self._buffer(t) for t in outs) \
            if name.rstrip("_") in DENSIFY_OPS else ()
        self.events.append(OpSite(
            primitive=name, index=len(self.events), path=self._path(),
            kind="aten", op=str(func),
            operands=tuple(tensor_sig(t) for t in _tensors(list(args)
                                                      + list(kwargs.values()))),
            outputs=tuple(tensor_sig(t) for t in outs), buffers=buffers,
            origin=_caller()))
        return out


def record_program(fn: Callable, *args, **kwargs) -> ProgramRecord:
    """Run ``fn(*args, **kwargs)`` once and record its collectives and
    ATen ops in the order they ran.  The caller chooses where it runs:
    the Trainer records on CPU copies of its state
    (``train/trainer.py``), so recording launches nothing on the card."""
    rec = _Recorder()
    prev = collectives.set_recorder(rec.collective)
    try:
        with rec:
            fn(*args, **kwargs)
    finally:
        collectives.set_recorder(prev)
        rec._held.clear()
    return ProgramRecord(events=tuple(rec.events))
