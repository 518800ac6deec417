"""Joining a rank group.

Port of ``avd_tpu/parallel/distributed.py``.  ``avd_tpu`` joins one
multi-host JAX runtime; the port runs one process per rank, as
``torchrun`` starts them, each calling ``initialize`` and then the same
program.  On a single process it is a no-op and the code path is the
single-device one.
"""

from __future__ import annotations

import datetime
import functools
import os
from typing import Optional

import torch
import torch.distributed as dist

from avd_tpu_torch import device as device_mod

# the device this process's rank computes on (set by initialize)
_RANK_DEVICE: Optional[torch.device] = None


def initialize(device=None, backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = 60.0) -> bool:
    """Join the rank group when configured; True if one was joined.

    The group comes from the arguments or torch's variables (``RANK``,
    ``WORLD_SIZE``, and ``MASTER_ADDR``/``MASTER_PORT`` for the default
    ``env://`` rendezvous); one process with no ``init_method`` is a
    no-op.  ``device`` (default CUDA, raising without it) is the rank's
    compute device: on CUDA the rank binds ``cuda:LOCAL_RANK %
    device_count()`` before the group starts.  The backend is ``nccl`` on
    CUDA and ``gloo`` on the CPU, unless the caller names one (``gloo``
    with CUDA tensors stages each collective through host memory,
    ``collectives.transport``).  Every collective of the group times out
    after ``timeout_s``."""
    global _RANK_DEVICE
    world_size = int(os.getenv("WORLD_SIZE", "1")) if world_size is None \
        else world_size
    rank = int(os.getenv("RANK", "0")) if rank is None else rank
    if world_size == 1 and init_method is None:
        return False
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        local = int(os.getenv("LOCAL_RANK", str(rank)))
        torch.cuda.set_device(local % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _RANK_DEVICE = dev
    return True


def shutdown() -> None:
    """Leave the group (no-op without one)."""
    global _RANK_DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _cp_mesh.cache_clear()
    _RANK_DEVICE = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device() -> torch.device:
    """The device ``initialize`` bound this rank to (CUDA by default)."""
    return _RANK_DEVICE if _RANK_DEVICE is not None else \
        device_mod.pinned(None)


def global_mesh(axes=("data", "model"), shape=None):
    """Mesh over every rank of the group (``mesh.make_mesh``)."""
    from avd_tpu_torch.parallel import mesh as mesh_mod
    return mesh_mod.make_mesh(None, axes=axes, shape=shape)


def cp_mesh():
    """The video path's time-axis mesh, or None on one rank.

    With more than one rank and ``AVD_CP`` not 0, the video feature
    pipeline shards each clip's frame sequence over this mesh with a
    one-frame halo (``parallel/halo.cp_video_pair_features``).  Built once
    per group: a mesh's sub-groups are made by a collective call."""
    if os.getenv("AVD_CP", "1") == "0" or world_size() < 2:
        return None
    return _cp_mesh(id(dist.group.WORLD))


@functools.lru_cache(maxsize=1)
def _cp_mesh(_group_id):
    from avd_tpu_torch.parallel import mesh as mesh_mod
    return mesh_mod.make_mesh(None, axes=("time",))

