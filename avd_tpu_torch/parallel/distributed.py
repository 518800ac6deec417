"""Joining a rank group.

Port of ``avd_tpu/parallel/distributed.py``.  ``avd_tpu`` joins one
multi-host JAX runtime; the port runs one process per rank, as
``torchrun`` starts them, each calling ``initialize`` and then the same
program.  On a single process it is a no-op and the code path is the
single-device one.

A served worker (``serve/group.py``) is a group whose ranks do not all
run the same program: its leader serves HTTP and enters the group's
programs for the others through ``run_on_group``.  There the programs
run over the group at any size, a group of one included (``spmd``).
"""

from __future__ import annotations

import datetime
import functools
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

from avd_tpu_torch import device as device_mod

# the device this process's rank computes on (set by initialize)
_RANK_DEVICE: Optional[torch.device] = None
# set on every rank of a served group (serve/group.py)
_SERVED = False
# set on a served group's leader: enters a call on every rank
# (serve/group.Leader); None everywhere else
_DISPATCH: Optional[Callable] = None
# the world group's collective timeout (set by initialize)
_TIMEOUT: Optional[datetime.timedelta] = None


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
    global _RANK_DEVICE, _TIMEOUT
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
    _TIMEOUT = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=_TIMEOUT)
    _RANK_DEVICE = dev
    return True


def shutdown() -> None:
    """Leave the group (no-op without one), a served group's state too."""
    global _RANK_DEVICE, _SERVED, _DISPATCH, _TIMEOUT
    if dist.is_initialized():
        dist.destroy_process_group()
    _cp_mesh.cache_clear()
    _RANK_DEVICE, _TIMEOUT = None, None
    _SERVED, _DISPATCH = False, None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device() -> torch.device:
    """The device ``initialize`` bound this rank to (CUDA by default)."""
    return _RANK_DEVICE if _RANK_DEVICE is not None else \
        device_mod.pinned(None)


def spmd() -> bool:
    """Whether the group's programs run over the group: a group of more
    than one rank, or a served group of any size."""
    return world_size() > 1 or (_SERVED and dist.is_initialized())


def run_on_group(fn: Callable, *arrays, device=None):
    """``fn(*arrays, device=device)``, on every rank of a served group.

    On a served group's leader the call goes through its dispatch point
    (``serve/group.Leader``): the arrays (numpy) go to every follower,
    which runs ``fn`` on them on its own device, and the answer comes back
    once every rank is done.  Everywhere else (one process, the dry run,
    ``torchrun`` programs, a follower) it is the plain call: every rank
    makes it itself."""
    if _DISPATCH is None:
        return fn(*arrays, device=device)
    return _DISPATCH(fn, arrays, device)


def global_mesh(axes=("data", "model"), shape=None):
    """Mesh over every rank of the group (``mesh.make_mesh``)."""
    from avd_tpu_torch.parallel import mesh as mesh_mod
    return mesh_mod.make_mesh(None, axes=axes, shape=shape)


def cp_enabled() -> bool:
    """Whether the video path runs context-parallel: ``spmd`` and
    ``AVD_CP`` not 0.  Its time axis is every rank of the group."""
    return os.getenv("AVD_CP", "1") != "0" and spmd()


def cp_mesh():
    """The video path's time-axis mesh, or None without ``cp_enabled``.

    The video feature pipeline shards each clip's frame sequence over this
    mesh with a one-frame halo (``parallel/halo.cp_video_pair_features``).
    Built once per group: a mesh's sub-groups are made by a collective
    call."""
    if not cp_enabled():
        return None
    return _cp_mesh(id(dist.group.WORLD))


@functools.lru_cache(maxsize=1)
def _cp_mesh(_group_id):
    from avd_tpu_torch.parallel import mesh as mesh_mod
    return mesh_mod.make_mesh(None, axes=("time",))

