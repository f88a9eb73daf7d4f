"""The port's mesh of processes and every collective it runs.

A :class:`Mesh` is the counterpart of a ``jax.sharding.Mesh``: named axes
(``("data", "model")``, or ``("pod", "data", "model")`` across nodes) over
processes joined by ``torch.distributed``, one rank a device, ranks laid
out row-major (the model axis fastest, as ``jax.make_mesh`` lays devices).
``Mesh.abstract`` gives a mesh of shape only, for the pure spec functions
of :mod:`repro_torch.parallel.sharding`.  ``Mesh.dry`` gives one rank of a
mesh with no processes at all, for the dry run (``launch/dryrun.py``):
its tensors live on the meta device, and each collective returns a meta
tensor of its result's shape, counts :data:`STATS` as a real run does and
appends (op, axes, group size, result bytes) to ``mesh.records``.

Every collective of the port goes through the functions below, which take
the mesh and the axes to run over, return new tensors, skip an axis of size
1 (a 1x1 mesh runs no collective), and count their calls, bytes and host
milliseconds in :data:`STATS`.  A failed collective raises; nothing falls
back to one rank.

The transport follows from the topology (:func:`repro_torch.launch.mesh.
init_mesh`): "nccl" when each rank owns a card; "gloo" on the CPU; and
"gloo+ipc" when the ranks share one card (NCCL refuses two ranks on one
GPU).  Gloo runs every collective used here on CUDA tensors
(``all_reduce`` sum, max and bf16, ``broadcast``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``; not the list ``all_to_all``), but through host
memory at ~0.37 GB/s a rank (``tools/gloo_cuda_probe.py`` on an NVIDIA H100
80GB HBM3, torch 2.11: 128 MiB a rank all-gathered in 349.4 ms).  So ranks
that share a card move their payloads through CUDA IPC (:class:`_Ipc`:
each rank's exchange buffer mapped into the others, device to device) and
use the gloo group for the barriers around each exchange; nothing is
staged through the host.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

# calls, bytes (each call's input on this rank) and host milliseconds of
# the collectives; reset with reset_stats()
STATS: Dict[str, float] = {}


def reset_stats() -> None:
    STATS.clear()
    STATS.update(calls=0, bytes=0, ms=0.0)


reset_stats()


@dataclasses.dataclass
class Mesh:
    """Named axes over processes.  ``shape`` maps an axis name to its size
    in layout order; ``coords`` this rank's index on each axis; ``groups``
    the process group of each tuple of axes (this rank's); ``device`` this
    rank's device; ``transport`` "nccl", "gloo" or "gloo+ipc".  A mesh made
    by :meth:`abstract` has a shape only."""

    shape: Dict[str, int]
    coords: Dict[str, int] = dataclasses.field(default_factory=dict)
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)
    device: Optional[torch.device] = None
    transport: str = ""
    # a group's CUDA IPC exchange (transport "gloo+ipc"), made at its first
    # collective
    ipc: Dict[Tuple[str, ...], Any] = dataclasses.field(default_factory=dict)
    # transport "dry": each collective's (op, axes, group size, result bytes)
    records: List[Tuple[str, Tuple[str, ...], int, int]] = \
        dataclasses.field(default_factory=list)

    @classmethod
    def abstract(cls, shape: Dict[str, int]) -> "Mesh":
        return cls(shape=dict(shape))

    @classmethod
    def dry(cls, shape: Dict[str, int], rank: int = 0) -> "Mesh":
        """Rank ``rank`` of a mesh of ``shape`` with no processes: the meta
        device, transport "dry"."""
        return cls(shape=dict(shape), coords=rank_coords(shape, rank),
                   device=torch.device("meta"), transport="dry")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def world(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes: Axes) -> int:
        """This rank's row-major index over ``axes`` (the first major)."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Axes):
        return self.groups[self.key(axes)]

    def key(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` in the mesh's order."""
        return tuple(a for a in self.axis_names if a in _axes(axes))


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def rank_coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """The coordinates of ``rank`` on a row-major mesh of ``shape``."""
    out = {}
    for a in reversed(list(shape)):
        rank, out[a] = divmod(rank, shape[a])
    return {a: out[a] for a in shape}


def make_groups(shape: Dict[str, int], rank: int):
    """This rank's process group for every non-empty tuple of axes.  Every
    rank calls ``new_group`` for every group, in one order (a collective
    call), and keeps its own; the whole mesh is the world group."""
    names = list(shape)
    world = math.prod(shape.values())
    coords = [rank_coords(shape, r) for r in range(world)]
    mine: Dict[Tuple[str, ...], Any] = {}
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(names, n):
            if n == len(names):
                mine[axes] = dist.group.WORLD
                continue
            rest = [a for a in names if a not in axes]
            classes: Dict[Tuple[int, ...], list] = {}
            for r, c in enumerate(coords):
                classes.setdefault(tuple(c[a] for a in rest), []).append(r)
            for ranks in classes.values():
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine[axes] = g
    return mine


# ---------------------------------------------------------------------------
# CUDA IPC between the ranks of one card
# ---------------------------------------------------------------------------
class _Ipc:
    """The payload exchange of a group whose ranks share one card: each
    rank owns an exchange buffer, mapped into every other rank of the group
    by CUDA IPC (``torch.multiprocessing``'s tensor handles, sent once over
    the gloo group).  :meth:`exchange` writes this rank's tensor into its
    buffer and all-gathers a header (its dtype and shape) over the gloo
    group, which is also the barrier after the writes; if the ranks sent
    different dtypes or shapes it raises a ``RuntimeError`` on every rank
    (as gloo and NCCL raise), else it returns every rank's tensor as views
    of the buffers.  :meth:`done` waits until every rank has read them, so
    no buffer is written while another rank reads it.  A buffer grows (to
    a power of two, handles sent again) when a message outgrows it: the
    ranks decide after the headers, so all grow at once."""

    def __init__(self, group, n: int, index: int):
        self.group, self.n, self.index = group, n, index
        self.bufs: List[torch.Tensor] = []
        self.cap = 0

    def _grow(self, nbytes: int, device) -> None:
        from torch.multiprocessing.reductions import (rebuild_cuda_tensor,
                                                      reduce_tensor)
        self.bufs = []
        dist.barrier(group=self.group)
        self.cap = 1 << max(20, (nbytes - 1).bit_length())
        mine = torch.empty(self.cap, dtype=torch.uint8, device=device)
        handles: List[Any] = [None] * self.n
        dist.all_gather_object(handles, reduce_tensor(mine)[1],
                               group=self.group)
        self.bufs = [mine if j == self.index else rebuild_cuda_tensor(*h)
                     for j, h in enumerate(handles)]

    def _payload(self, j: int, x: torch.Tensor) -> torch.Tensor:
        nbytes = x.numel() * x.element_size()
        return self.bufs[j][:nbytes].view(x.dtype).view(x.shape)

    def exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        nbytes = x.numel() * x.element_size()
        if not self.bufs:
            self._grow(nbytes, x.device)
        fits = nbytes <= self.cap
        if fits:
            self._payload(self.index, x).copy_(x)
        torch.cuda.current_stream(x.device).synchronize()
        head = _header(x)
        heads = [torch.empty_like(head) for _ in range(self.n)]
        dist.all_gather(heads, head, group=self.group)
        if not all(torch.equal(h, head) for h in heads):
            raise RuntimeError(
                f"ranks sent different tensors to one collective: "
                f"{[_describe(h) for h in heads]}")
        if not fits:
            # every rank's message outgrew its buffer: all grow at once
            self._grow(nbytes, x.device)
            self._payload(self.index, x).copy_(x)
            torch.cuda.current_stream(x.device).synchronize()
            dist.barrier(group=self.group)
        return [self._payload(j, x) for j in range(self.n)]

    def done(self, device) -> None:
        torch.cuda.current_stream(device).synchronize()
        dist.barrier(group=self.group)


# a message's header (a host tensor of _HEAD int64): the dtype's code,
# ndim, the shape
_HEAD = 16
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int64,
           torch.int32, torch.uint8, torch.bool, torch.float64)


def _header(x: torch.Tensor) -> torch.Tensor:
    if x.ndim > _HEAD - 2:
        raise ValueError(f"a {x.ndim}-dimensional tensor: at most "
                         f"{_HEAD - 2} dimensions through CUDA IPC")
    code = _DTYPES.index(x.dtype) if x.dtype in _DTYPES else \
        len(_DTYPES) + x.element_size()
    head = torch.zeros(_HEAD, dtype=torch.int64)
    head[:2 + x.ndim] = torch.tensor([code, x.ndim, *x.shape])
    return head


def _describe(head: torch.Tensor) -> str:
    code, ndim = int(head[0]), int(head[1])
    dtype = _DTYPES[code] if code < len(_DTYPES) else f"dtype #{code}"
    return f"{dtype}{tuple(int(v) for v in head[2:2 + ndim])}"


def _exchange(mesh: Mesh, axes: Axes):
    key = mesh.key(axes)
    if key not in mesh.ipc:
        mesh.ipc[key] = _Ipc(mesh.group(key), mesh.size(key),
                             mesh.index(key))
    return mesh.ipc[key]


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------
def _run(op: str, mesh: Mesh, axes: Axes, x: torch.Tensor, shape,
         by_ipc, by_group):
    """Collective ``op`` of ``x`` over ``axes``, its result of ``shape``:
    ``by_ipc(ex, x)`` through the group's CUDA IPC exchange (transport
    "gloo+ipc", a CUDA tensor), ``by_group(group, x)`` through the process
    group, or on a dry mesh a meta tensor of ``shape``, recorded; counts
    calls, bytes and host milliseconds."""
    t0 = time.perf_counter()
    if (mesh.transport == "dry") != x.is_meta:
        raise ValueError(f"{op}: a {x.device} tensor on a mesh of transport "
                         f"{mesh.transport!r}; meta tensors go to a dry mesh "
                         "and only there")
    if mesh.transport == "dry":
        # the local ops of by_group's path: a copy for the in-place ones
        out = x.clone() if op in ("all_reduce", "broadcast") else \
            torch.empty(shape, dtype=x.dtype, device="meta")
        mesh.records.append((op, mesh.key(axes), mesh.size(axes),
                             out.numel() * out.element_size()))
    elif x.is_cuda and mesh.transport == "gloo+ipc":
        ex = _exchange(mesh, axes)
        out = by_ipc(ex, x)
        ex.done(x.device)
    else:
        out = by_group(mesh.group(axes), x)
    STATS["calls"] += 1
    STATS["bytes"] += x.numel() * x.element_size()
    STATS["ms"] += (time.perf_counter() - t0) * 1e3
    return out


def _sum(parts, op: str):
    """The ranks' parts reduced in rank order (the same bits on every
    rank)."""
    out = parts[0].clone()
    for p in parts[1:]:
        if op == "max":
            torch.maximum(out, p, out=out)
        else:
            out += p
    return out


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Axes,
               op: str = "sum") -> torch.Tensor:
    """The sum (or "max") of ``x`` over ``axes``, in x's dtype."""
    if mesh.size(axes) == 1:
        return x
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

    def by_group(group, t):
        t = t.clone()
        dist.all_reduce(t, op=red, group=group)
        return t
    x = x.contiguous()
    return _run("all_reduce", mesh, axes, x, x.shape,
                lambda ex, t: _sum(ex.exchange(t), op), by_group)


def broadcast(x: torch.Tensor, mesh: Mesh, axes: Axes,
              src: int = 0) -> torch.Tensor:
    """``x`` of index ``src`` over ``axes``, on every rank there."""
    if mesh.size(axes) == 1:
        return x

    def by_group(g, t):
        t = t.clone()
        dist.broadcast(t, dist.get_global_rank(g, src), group=g)
        return t
    x = x.contiguous()
    return _run("broadcast", mesh, axes, x, x.shape,
                lambda ex, t: ex.exchange(t)[src].clone(), by_group)


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Axes,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` over ``axes`` concatenated along ``dim`` in index
    order."""
    n = mesh.size(axes)
    if n == 1:
        return x
    dim = dim % x.ndim
    xm = x.movedim(dim, 0).contiguous()

    def by_group(group, t):
        out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    return _run("all_gather", mesh, axes, xm,
                (n * xm.shape[0], *xm.shape[1:]),
                lambda ex, t: torch.cat(ex.exchange(t)),
                by_group).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes: Axes,
                   dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, cut in equal blocks along ``dim``;
    each rank keeps the block of its index."""
    n = mesh.size(axes)
    if n == 1:
        return x
    dim = dim % x.ndim
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    xm = x.movedim(dim, 0).contiguous()
    w = xm.shape[0] // n

    def by_group(group, t):
        out = torch.empty((w, *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, t, group=group)
        return out

    def by_ipc(ex, t):
        i = mesh.index(axes)
        return _sum([p[i * w:(i + 1) * w] for p in ex.exchange(t)], "sum")
    return _run("reduce_scatter", mesh, axes, xm, (w, *xm.shape[1:]),
                by_ipc, by_group).movedim(0, dim)


def all_to_all(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """``x``'s dim 0 cut in n equal blocks, block j sent to index j; the
    result's block i is what index i sent (``lax.all_to_all`` with
    split_axis = concat_axis = 0)."""
    n = mesh.size(axes)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split over {n} ranks")

    def by_group(group, t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    def by_ipc(ex, t):
        i = mesh.index(axes)
        return torch.cat([p.chunk(n)[i] for p in ex.exchange(t)])
    x = x.contiguous()
    return _run("all_to_all", mesh, axes, x, x.shape, by_ipc, by_group)


def barrier(mesh: Mesh) -> None:
    if mesh.world > 1 and mesh.transport != "dry":
        dist.barrier(group=mesh.group(mesh.axis_names))
