"""The serving subset of ``repro/parallel/sharding.py``: which pod host owns
which lanes of the serving engine's slot array.

In the reference the slot axis is sharded over the mesh's ``data`` axis
(``slot_specs``), so lane i's rows live on the host that owns lane i
(``lane_owners``).  The port's pod hosts are processes, each with its own
device: a host holds its block of lanes (:func:`host_block`) in its own
slot array, and no lane's tensors ever cross hosts.

``gathered_sharding`` has no counterpart.  The reference replicates its
(k, slots) done stack across the pod, the one collective of its serving
loop, because its hosts learn from the device which lanes finished.  The
port's host plans every lane's done tick from the positions it tracks
before the window runs, so every host already holds the whole stack and a
window needs no collective.  What the gathered stack enforced, that every
host retires the same lanes at the same boundary, the engine checks once at
the end of a serve instead, by all-gathering each host's schedule digest.

The rest of the reference module (``param_specs``, ``cache_specs``,
``batch_specs``, the client-stack and pooled specs, FSDP) waits for the
DTensor slice of the LM side path.
"""
from __future__ import annotations

import numpy as np


def lane_owners(slots: int, hosts: int) -> np.ndarray:
    """Owner host of every serving-engine lane: contiguous blocks of
    ``slots // hosts`` lanes in host order (``sharding.py:233``)."""
    assert hosts >= 1 and slots % hosts == 0, (slots, hosts)
    return np.repeat(np.arange(hosts), slots // hosts)


def host_block(slots: int, hosts: int, host_id: int) -> slice:
    """The lanes host ``host_id`` owns, as a slice of the slot axis: the
    block the reference's ``slot_specs`` lays on that host's ``data``
    shard."""
    assert 0 <= host_id < hosts, (host_id, hosts)
    width = int((lane_owners(slots, hosts) == host_id).sum())
    return slice(host_id * width, (host_id + 1) * width)
