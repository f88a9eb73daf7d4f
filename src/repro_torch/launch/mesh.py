"""Meshes and pods of the port (counterpart of ``repro/launch/mesh.py``).

The reference lays a (data, model) mesh over the devices of one JAX
program.  In the port N devices means N processes joined by
``torch.distributed``, each a rank with one device.  :func:`init_mesh`
opens the group and returns the rank's :class:`~repro_torch.parallel.comm.
Mesh`, which carries the axes and the process group of each tuple of
axes.

The transport follows from the topology: a rank owns card ``rank`` over
NCCL when the machine has a card a rank; otherwise every rank shares card
0 ("gloo+ipc": a gloo group for the barriers, the payloads through CUDA
IPC, ``parallel/comm.py``; NCCL refuses two ranks on one GPU); on the CPU
the group is gloo.  :func:`init_pod` is the serving engine's pod: hosts on the data
axis, exchanging host-side objects only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import math
import os
import signal
import socket
import time
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.comm import Mesh, make_groups, rank_coords

# an H100 node's cards, the production mesh's model axis
CARDS_PER_NODE = 8

# NVIDIA H100 SXM hardware constants used by the roofline (a card; the data
# sheet's dense rates): the bf16 tensor-core rate, HBM3's bandwidth, NVLink's
# bandwidth in each direction (the model axis, inside a node) and the
# network's (an axis across nodes, data and pod: one 400 Gb/s NIC a card)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s
NVLINK_BW = 450e9                 # B/s a card, each direction
NET_BW = 50e9                     # B/s a card


def link_class(shape, axes) -> str:
    """"nvlink" when each group over ``axes`` of a row-major mesh of
    ``shape`` ({axis: size}, the model axis fastest) lies inside one node
    of :data:`CARDS_PER_NODE` consecutive ranks, else "net"."""
    names = list(shape)
    axes = [axes] if isinstance(axes, str) else list(axes)
    slowest = min(names.index(a) for a in axes)
    block = math.prod(shape[a] for a in names[slowest:])
    return "nvlink" if CARDS_PER_NODE % block == 0 else "net"


def parse_mesh_shape(mesh_shape: str) -> Tuple[int, ...]:
    """"DxM" (or "PxDxM") as integers; a ``ValueError`` otherwise."""
    try:
        dims = tuple(int(x) for x in mesh_shape.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh shape {mesh_shape!r} is not DxM") from None
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"mesh shape {mesh_shape!r} is not DxM")
    return dims


def host_mesh(mesh_shape: str = "",
              devices: Optional[int] = None) -> Tuple[int, int]:
    """The (data, model) shape of ``devices`` devices: ``mesh_shape`` is
    "DxM" (e.g. "2x4"), empty for every device on the data axis; without
    ``devices`` the shape sets their number.  Raises a ``ValueError`` for
    a shape that does not cover the devices."""
    if mesh_shape:
        dims = parse_mesh_shape(mesh_shape)
        if len(dims) != 2:
            raise ValueError(f"mesh shape {mesh_shape!r} is not DxM")
        d, m = dims
    else:
        d, m = devices or 1, 1
    if devices is None:
        devices = d * m
    if d * m != devices:
        raise ValueError(f"mesh {d}x{m} does not cover {devices} devices")
    return d, m


def axes_for(dims: Tuple[int, ...]) -> Tuple[str, ...]:
    return ("data", "model") if len(dims) == 2 else ("pod", "data", "model")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over ``axes`` with no processes (its specs and
    sizes only); :func:`init_mesh` opens one for a rank."""
    return Mesh.abstract(dict(zip(axes, shape)))


def make_production_mesh(*, multi_pod: bool = False, nodes: int = 2,
                         pods: int = 2) -> Mesh:
    """H100 nodes: a node's 8 cards on ``model`` (NVLink), ``nodes`` nodes
    on ``data``, and with ``multi_pod`` ``pods`` pods on ``pod``."""
    if multi_pod:
        return make_mesh((pods, nodes, CARDS_PER_NODE),
                         ("pod", "data", "model"))
    return make_mesh((nodes, CARDS_PER_NODE), ("data", "model"))


def make_demo_mesh(data: int = 2, model: int = 4) -> Mesh:
    """A small (data, model) mesh for the spec tests."""
    return make_mesh((data, model), ("data", "model"))


def batch_axes_of(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mesh_context(mesh: Mesh):
    """``with mesh_context(mesh) as m:`` the reference's ambient-mesh
    context; the port passes its mesh in a ``ShardCtx`` and sets nothing,
    so this only yields the mesh."""
    return contextlib.nullcontext(mesh)


def transport_for(device_type: str, ranks: int) -> Tuple[str, int]:
    """(transport, cards): "nccl" with a card a rank when the machine has at
    least ``ranks`` cards, "gloo+ipc" with every rank on card 0 when it has
    fewer, "gloo" on the CPU."""
    if device_type == "cpu":
        return "gloo", 0
    cards = torch.cuda.device_count()
    if cards >= ranks:
        return "nccl", cards
    return "gloo+ipc", cards


def init_mesh(dims: Tuple[int, ...], rank: int, coordinator: str, *,
              device_type: str = "cuda",
              timeout_s: float = 300.0) -> Mesh:
    """Open the process group of a mesh of ``dims`` ((D, M) or (P, D, M))
    as rank ``rank`` at ``coordinator`` ("host:port") and return its
    :class:`Mesh`: the device (card ``rank`` under NCCL, else card 0, or
    the CPU), the transport (:func:`transport_for`) and a process group
    for every tuple of axes.  A group that does not open raises."""
    world = math.prod(dims)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of {world}")
    transport, _ = transport_for(device_type, world)
    if device_type == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank if transport == "nccl" else 0)
        torch.cuda.set_device(device)
    axes = axes_for(dims)
    shape = dict(zip(axes, dims))
    nccl = transport == "nccl"
    dist.init_process_group(
        "nccl" if nccl else "gloo", init_method=f"tcp://{coordinator}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
        **({"device_id": device} if nccl else {}))
    return Mesh(shape=shape, coords=rank_coords(shape, rank),
                groups=make_groups(shape, rank), device=device,
                transport=transport)


def close_mesh(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.groups and dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def launcher_rank(rank: int, port: int, dims: Tuple[int, ...],
                  device_type: str):
    """A launcher's rank for the block: its mesh (rendezvous on localhost
    ``port``), the CPU's threads shared out among the ranks, the standard
    output of ranks other than 0 discarded; the group closed after."""
    if device_type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() //
                                  math.prod(dims)))
    mesh = init_mesh(dims, rank, f"127.0.0.1:{port}",
                     device_type=device_type)
    try:
        quiet = contextlib.nullcontext() if rank == 0 else \
            contextlib.redirect_stdout(io.StringIO())
        with quiet:
            yield mesh
    finally:
        close_mesh(mesh)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _in_session(target, rank: int, port: int, args) -> None:
    os.setsid()
    target(rank, port, *args)


def run_ranks(target, world: int, args=(), *, timeout_s: float) -> None:
    """Run ``target(rank, port, *args)`` in ``world`` processes (the
    ``spawn`` start method, which CUDA needs), each in its own session, a
    free localhost ``port`` for their rendezvous.  Waits until every rank
    exits; a rank that fails or the deadline kills every rank's session
    and raises, so no rank waits on a dead peer."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_in_session, args=(target, r, port, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    failed = ""
    try:
        while any(p.exitcode is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.exitcode]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].exitcode}"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks did not finish in {timeout_s:.0f} s"
                break
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.exitcode]
        if bad and not failed:
            failed = f"rank {bad[0]} exited with {procs[bad[0]].exitcode}"
    finally:
        for p in procs:
            if p.exitcode is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            p.join()
    if failed:
        raise RuntimeError(f"mesh of {world} ranks failed: {failed}")


@dataclasses.dataclass(frozen=True)
class Pod:
    """One host's handle on its pod: ``hosts`` processes, this one
    ``host_id``, joined by a gloo group.  Objects travel pickled."""

    hosts: int
    host_id: int
    group: Any = None

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def all_gather_object(self, obj) -> List:
        """``obj`` of every host, in host order."""
        out: List = [None] * self.hosts
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def close(self) -> None:
        dist.destroy_process_group(self.group)


def init_pod(coordinator: str, num_processes: int, process_id: int,
             timeout_s: float = 300.0) -> Optional[Pod]:
    """Join the pod of ``num_processes`` hosts whose rendezvous is
    ``coordinator`` ("host:port"), as host ``process_id``.  Returns None for
    one process.  A group that does not open raises: a host never serves
    alone in place of its pod."""
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} of {num_processes}")
    if num_processes == 1:
        return None
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return Pod(hosts=num_processes, host_id=process_id,
               group=dist.group.WORLD)
