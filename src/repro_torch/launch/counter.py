"""The work counter of the dry run and the roofline (the port's stand-in
for XLA's ``cost_analysis`` and ``memory_analysis``).

:class:`WorkCounter` is a ``TorchDispatchMode``: every aten op that runs
under it is counted, on any device, the meta device included.

* FLOPs: ``torch.utils.flop_counter``'s formulas (matmul, bmm, addmm,
  baddbmm, convolution; an einsum reaches them as bmm); other ops count 0.
* Bytes: the bytes of every tensor an op takes plus every tensor it
  returns, for each op that is neither a view nor an allocation alone
  (:data:`FREE_OPS`).  The port runs eagerly, op by op, so this is what it
  moves through memory, not only a floor.
* Memory: each storage an op creates (an output's storage that none of
  its inputs holds) is live until it is freed; ``peak_bytes`` is the most
  live at once, beyond what existed before the counter started.
* Kernels: a kernel wrapper of :mod:`repro_torch.kernels.ops` is one unit
  (the wrapper finds the counter through
  :func:`repro_torch.kernels.units.active`), counted by the kernel's own
  formulas (:meth:`WorkCounter.unit`) whether
  it runs its plain version (the CPU), its kernel (a card) or its
  shape-only branch (meta); nothing inside it is counted.

So a step on the meta device counts what the same step counts on a card,
op for op.  Ops with no meta kernel whose output shape follows from their
arguments get one here (:data:`META_SHAPES`).  On meta, where many kernels
are Python shape rules, an op's outputs are made from the metadata it gave
for the same arguments' metadata before.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops that move no data: they allocate without writing
FREE_OPS = frozenset({
    aten.empty.memory_format, aten.empty_like.default,
    aten.empty_strided.default, aten.new_empty.default,
    aten.new_empty_strided.default})


# the collectives' own ops: their traffic is link bytes (the dry mesh's
# records), not memory
LINK_NAMESPACES = frozenset({"c10d", "_c10d_functional"})


def _bincount_meta(x, weights=None, minlength=0):
    """``bincount`` on meta: (minlength,) int64, which is its shape when
    every value lies below ``minlength`` (the router's expert ids)."""
    if weights is not None or not minlength:
        raise NotImplementedError("bincount on meta needs minlength and no "
                                  "weights")
    return torch.empty((minlength,), dtype=torch.int64, device="meta")


# elementwise ops XLA counts as transcendentals: one an output element
TRANSCENDENTAL = frozenset(getattr(aten, n) for n in (
    "exp", "exp_", "expm1", "log", "log_", "log1p", "tanh", "tanh_",
    "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "sin", "cos",
    "erf", "pow", "pow_", "silu", "silu_", "gelu", "softplus", "_softmax",
    "_log_softmax"))


# shape-only results for ops that have no meta kernel
META_SHAPES: Dict[object, Callable] = {aten.bincount.default: _bincount_meta}


# argument types a meta op's cached outputs may be keyed on
_KEYS = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
         torch.memory_format)
_TENSOR = "tensor"


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), "CompositeImplicitAutograd")


@functools.lru_cache(maxsize=None)
def _functional(func) -> bool:
    """Whether ``func`` writes none of its arguments and returns fresh
    tensors (no view, no alias)."""
    schema = func._schema
    return not func.is_view and not schema.is_mutable and not any(
        r.alias_info is not None for r in schema.returns)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(obj, out=None) -> list:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts), in order."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    return out


def _key(obj, key: list) -> bool:
    """Append ``obj``'s metadata to ``key``; False if it has a part that
    cannot key an op's outputs."""
    if isinstance(obj, torch.Tensor):
        key.append((tuple(obj.shape), obj.stride(), obj.dtype))
    elif isinstance(obj, (list, tuple)):
        key.append(("seq", len(obj)))
        return all(_key(o, key) for o in obj)
    elif obj is None or isinstance(obj, _KEYS):
        key.append((type(obj), obj))
    else:
        return False
    return True


def _template(out):
    """A result's structure with each tensor's shape, strides and dtype."""
    if isinstance(out, torch.Tensor):
        return (_TENSOR, tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), [_template(o) for o in out])
    return (None, out)


def _build(tmpl):
    kind = tmpl[0]
    if kind is _TENSOR:
        return torch.empty_strided(tmpl[1], tmpl[2], dtype=tmpl[3],
                                   device="meta")
    if kind is None:
        return tmpl[1]
    return kind(_build(t) for t in tmpl[1])


class WorkCounter(TorchDispatchMode):
    """``with WorkCounter() as c:`` counts the work of the block:
    ``c.flops``, ``c.bytes``, ``c.ops`` (aten ops counted),
    ``c.transcendentals``, ``c.units`` (``{kernel: {"calls", "flops",
    "bytes"}}``) and ``c.peak_bytes``."""

    counts_kernel_units = True

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.transcendentals = 0
        self.units: Dict[str, Dict[str, int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}
        self._inside = 0
        self._memo: Dict[tuple, tuple] = {}
        self._meta_outs: Dict[tuple, tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # a composite op (matmul, einsum, softmax, to, ...) reaches the
            # mode whole where autograd does not decompose it (inference
            # mode): run its decomposition under the counter, which sees
            # the ops it runs, as under autograd
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        ins = _tensors((args, kwargs))
        if ins and all(t.is_meta for t in ins):
            out = self._on_meta(func, args, kwargs, ins)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        if not self._inside and not func.is_view and func not in FREE_OPS \
                and func.namespace not in LINK_NAMESPACES:
            self.ops += 1
            self.bytes += sum(nbytes(t) for t in ins) + \
                sum(nbytes(t) for t in outs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += int(count(*args, **kwargs, out_val=out))
            if func._overloadpacket in TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in outs)
        self._track(ins, outs)
        return out

    def _on_meta(self, func, args, kwargs, ins):
        """``func`` on meta tensors.  Many meta kernels are Python (the
        shape rules of ``torch._refs``, ~0.2 ms a call), so a functional
        op's outputs are made from the shapes, strides and dtypes it gave
        for the same arguments' metadata before (an op's output metadata
        follows from its arguments' alone)."""
        meta = META_SHAPES.get(func)
        if meta is not None:
            return meta(*args, **kwargs)
        if not _functional(func):
            return func(*args, **kwargs)
        key = [func, tuple(kwargs)]
        if not _key((args, tuple(kwargs.values())), key):
            return func(*args, **kwargs)
        key = tuple(key)
        hit = self._meta_outs.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            held = {t.untyped_storage()._cdata for t in ins}
            # an op that returns an alias whatever its schema says
            # (_unsafe_view) runs every time
            self._meta_outs[key] = False if any(
                t.untyped_storage()._cdata in held
                for t in _tensors(out)) else _template(out)
            return out
        if hit is False:
            return func(*args, **kwargs)
        return _build(hit)

    def _track(self, ins, outs) -> None:
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in held or key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key, 0)

    @contextlib.contextmanager
    def unit(self, name: str, key: tuple, work: Callable[[], tuple]):
        """The block is kernel ``name``'s call: ``work()`` gives its
        (flops, bytes), memoised on ``key`` (the call's shapes and
        arguments); the ops inside are not counted."""
        if key not in self._memo:
            self._memo[key] = tuple(int(v) for v in work())
        flops, moved = self._memo[key]
        u = self.units.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        u["calls"] += 1
        u["flops"] += flops
        u["bytes"] += moved
        self.flops += flops
        self.bytes += moved
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1
