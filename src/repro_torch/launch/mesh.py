"""Meshes and pods of the port (counterpart of ``repro/launch/mesh.py``).

The reference lays a (data, model) mesh over the devices of one JAX
program.  In the port N devices means N processes: a pod of hosts joined by
a ``torch.distributed`` process group, each host driving its own device.
Only the ``data`` axis exists here: a ``model`` axis above 1 (the U-Net's
convolution channels sharded across devices) waits for the DTensor slice
(ROADMAP Queue 1, item 4.5).

The group is gloo over CPU tensors.  It carries only host-side objects (the
serving engine's schedule digest), it opens for two processes on one card
as for two on the CPU, and NCCL refuses two ranks on one GPU.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, List, Optional, Tuple

import torch.distributed as dist


def host_mesh(mesh_shape: str = "",
              devices: Optional[int] = None) -> Tuple[int, int]:
    """The (data, model) shape of ``devices`` devices: ``mesh_shape`` is
    "DxM" (e.g. "2x1"), empty for every device on the data axis; without
    ``devices`` the shape sets their number.  Raises a ``ValueError`` for a
    shape that does not cover the devices, and for M > 1."""
    if mesh_shape:
        try:
            d, m = (int(x) for x in mesh_shape.lower().split("x"))
        except ValueError:
            raise ValueError(f"mesh shape {mesh_shape!r} is not DxM") \
                from None
    else:
        d, m = devices or 1, 1
    if devices is None:
        devices = d * m
    if d < 1 or m < 1 or d * m != devices:
        raise ValueError(f"mesh {d}x{m} does not cover {devices} devices")
    if m > 1:
        raise ValueError(f"mesh {d}x{m}: a model axis above 1 (the U-Net's "
                         "channels sharded across devices) waits for the "
                         "DTensor slice, ROADMAP Queue 1 item 4.5")
    return d, m


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
