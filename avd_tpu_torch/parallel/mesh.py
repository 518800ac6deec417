"""Device meshes and parameter sharding over a rank group.

Port of ``avd_tpu/parallel/mesh.py``.  Axes, as in ``avd_tpu``:

    data   — batch parallelism (frames, clips)
    model  — tensor parallelism (attention heads, MLP hidden, experts)
    stage  — pipeline parallelism (the layer stack)
    time   — context parallelism over a clip's frame sequence

``avd_tpu`` has one controller placing arrays on a mesh of devices; the
port has one process per rank (``parallel/distributed.py``), and a mesh
is a ``torch.distributed`` ``DeviceMesh`` over every rank of the group
whose dim names are those axes.  A partition spec is a tuple with one
entry per array dim, an axis name or ``None`` (``P(None, "model")``, as
``jax.sharding.PartitionSpec`` reads), and a rank keeps the contiguous
slice of each leaf that its coordinates select (``shard_params``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from avd_tpu_torch.parallel import collectives


def P(*entries) -> Tuple:
    """A partition spec: one axis name or ``None`` per dim; ``P()``
    replicates the whole leaf."""
    return tuple(entries)


def factor2(n: int) -> Tuple[int, int]:
    """Largest p ≤ √n dividing n → (n//p, p); used for (data, model)."""
    p = int(np.sqrt(n))
    while p > 1 and n % p:
        p -= 1
    return n // p, p


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data", "model"),
              shape: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over every rank of the initialised group.

    Without ``shape``, a 2-axis mesh gets a balanced factorization and any
    other arity puts all ranks on the first axis.  ``n_devices`` must be
    the group's size when given: a mesh spans the whole group, since
    every rank runs the same program."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/distributed.initialize)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"requested {n_devices} ranks; the group has {n}")
    if shape is None:
        shape = factor2(n) if len(axes) == 2 else \
            (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} "
                         "ranks")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def _device_type() -> str:
    from avd_tpu_torch.parallel import distributed
    return distributed.rank_device().type


def mesh_shape(mesh) -> dict:
    """``{axis: size}``, as ``jax.sharding.Mesh.shape`` reads."""
    return {a: collectives.axis_size(mesh, a) for a in mesh.mesh_dim_names}


def local_slice(x: torch.Tensor, spec: Tuple, index: Callable[[str], int],
                size: Callable[[str], int]) -> torch.Tensor:
    """The block of ``x`` that the coordinates ``index(axis)`` select out of
    ``size(axis)`` along each dim the spec names, as a new contiguous
    tensor on ``x``'s device."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        if not isinstance(axis, str):
            raise ValueError(f"spec entry {axis!r}: one axis name per dim")
        n = size(axis)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} not divisible "
                             f"by {axis} axis {n}")
        step = x.shape[d] // n
        x = x.narrow(d, index(axis) * step, step)
    return x.contiguous().clone()


def _tree_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_params(mesh, params: Any, specs: Any) -> Any:
    """This rank's shards of a parameter tree: each leaf cut by the spec at
    the same path (``param_specs`` of the family), the rank keeping the
    contiguous slice its mesh coordinates select."""
    return _tree_map(
        lambda x, s: local_slice(
            x, s, lambda a: collectives.axis_index(mesh, a),
            lambda a: collectives.axis_size(mesh, a)),
        params, specs)


def gather_params(mesh, tree: Any, specs: Any) -> Any:
    """The inverse of ``shard_params``: every leaf all-gathered along each
    dim its spec names, so every rank holds the whole tree (no gradient)."""
    def gather(x, spec):
        x = x.detach()
        with torch.no_grad():
            for d, axis in enumerate(spec):
                if axis is not None:
                    x = collectives.all_gather(x, mesh, axis, dim=d)
        return x
    return _tree_map(gather, tree, specs)


def batch_slice(mesh, x, axis: str = "data"):
    """This rank's slice of a batch along ``axis`` (dim 0): the counterpart
    of ``batch_sharding``.  The batch must divide by the axis."""
    n = collectives.axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by {axis} "
                         f"axis {n}")
    step = x.shape[0] // n
    i = collectives.axis_index(mesh, axis)
    return x[i * step:(i + 1) * step]
