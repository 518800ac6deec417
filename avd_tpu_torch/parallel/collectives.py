"""The collectives of the port, on named mesh dims.

Counterparts of the ``jax.lax`` primitives that ``avd_tpu``'s
``shard_map`` code calls (``axis_index``, ``axis_size``, ``ppermute``,
``psum``, ``all_to_all``, ``all_gather``, ``psum_scatter``), over one
named dim of a ``torch.distributed`` ``DeviceMesh``
(``parallel/mesh.py``).  Every rank runs the same program, so every rank
calls the same collectives in the same order, as every device does inside
``shard_map``.  This is the only module of the port that calls
``torch.distributed`` collectives.

The transport is chosen from the group's backend and the tensor's device,
never by catching an error (``transport``):

* ``nccl``: the tensor goes to NCCL as it is;
* ``gloo`` with a CPU tensor: to gloo as it is;
* ``gloo`` with a CUDA tensor: staged through a pinned host buffer, the
  collective run by gloo on it, the result copied back to the tensor's
  card.  PyTorch documents gloo on CUDA tensors for ``broadcast`` and
  ``all_reduce`` only; the port stages every kind alike.  The compute
  stays on the card: this is how several ranks share one card, not a
  device fallback.  ``probe_gloo_cuda`` reports which kinds gloo takes
  directly, for the record;
* ``local``: a ``ppermute`` over a dim of size 1 is the identity (the
  only permutation of one member) and moves nothing.

``COUNTS`` counts the calls by (kind, transport), as the kernel wrappers
count their launches; ``reset_counts`` and ``counts`` read them.  A
backward pass's calls count under the kind they make.

Gradients.  ``avd_tpu`` never writes a backward pass: ``shard_map``'s
transpose rules derive them.  Here each collective is a
``torch.autograd.Function`` whose backward is the VJP those rules give,
over the same axis:

==============================  =========================================
forward                         backward
==============================  =========================================
``all_gather`` (tiled)          ``psum_scatter`` of the cotangent
``psum_scatter`` (tiled)        ``all_gather`` of the cotangent
``ppermute(perm)``              ``ppermute`` by the inverse permutation
``all_to_all(split, concat)``   ``all_to_all(concat, split)``
``psum`` (a region's exit)      identity
``enter`` (a region's entry)    ``psum``
==============================  =========================================

``psum`` and ``enter`` are Megatron's pair.  A region's exit sums the
members' partial results, and what follows it runs alike on every member,
so the cotangent that reaches the sum is already the same on each: its
backward passes it on unchanged (summing it would count it once per
member).  A region's entry hands a value that every member holds alike to
computations that differ by member (each its heads, its experts, its
pipeline stage): the forward is the identity and the backward sums the
members' cotangents, without which each member's gradient of the value
would be only its own share.  Under ``torch.no_grad`` (or for a tensor
that needs no gradient) every function runs its forward alone, and
``enter`` moves nothing.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

COUNTS: Dict[Tuple[str, str], int] = {}

_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> Dict[str, int]:
    """``{"kind/transport": calls}`` since the last ``reset_counts``, and
    ``staged``: the calls that went through host buffers."""
    out = {f"{k}/{t}": n for (k, t), n in sorted(COUNTS.items())}
    out["staged"] = sum(n for (_, t), n in COUNTS.items()
                        if t == "gloo-staged")
    return out


def transport(backend: str, device: torch.device) -> str:
    """How a collective of ``backend`` moves a tensor on ``device``:
    ``"nccl"``, ``"gloo"`` or ``"gloo-staged"``."""
    backend = str(backend).lower()
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("an NCCL group takes CUDA tensors only")
        return "nccl"
    if backend == "gloo":
        return "gloo-staged" if device.type == "cuda" else "gloo"
    raise ValueError(f"unsupported backend {backend!r}")


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    """Members of the mesh dim ``axis`` (``jax.lax.axis_size``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def _record(kind: str, how: str) -> None:
    COUNTS[(kind, how)] = COUNTS.get((kind, how), 0) + 1


def _how(kind: str, group, x: torch.Tensor) -> str:
    how = transport(dist.get_backend(group), x.device)
    _record(kind, how)
    return how


def _staged(fn, inputs: Sequence[torch.Tensor],
            outputs: Sequence[torch.Tensor]) -> None:
    """Run ``fn(host_inputs, host_outputs)`` on pinned host copies of CUDA
    tensors, then copy the host outputs back into ``outputs``."""
    h_in = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
            for x in inputs]
    h_out = [torch.zeros(y.shape, dtype=y.dtype, pin_memory=True)
             for y in outputs]
    fn(h_in, h_out)
    for y, h in zip(outputs, h_out):
        y.copy_(h)


def _ppermute(x: torch.Tensor, mesh, axis: str,
              perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    n = axis_size(mesh, axis)
    me = axis_index(mesh, axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    if n == 1:
        _record("ppermute", "local")
        return x.clone() if (0, 0) in perm else out
    group = _group(mesh, axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    how = _how("ppermute", group, x)

    def post(send, recv):
        ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, d),
                          group) for d in dst]
        ops += [dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, s),
                           group) for s in src]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    if how == "gloo-staged":
        _staged(lambda hi, ho: post(hi[0], ho[0]), [x], [out])
    else:
        post(x, out)
    return out


def _psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    group = _group(mesh, axis)
    out = x.contiguous().clone()
    if _how("psum", group, out) == "gloo-staged":
        _staged(lambda hi, ho: (dist.all_reduce(hi[0], group=group),
                                ho[0].copy_(hi[0])), [out], [out])
    else:
        dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
                ) -> torch.Tensor:
    group = _group(mesh, axis)
    n = axis_size(mesh, axis)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if _how("all_gather", group, xm) == "gloo-staged":
        _staged(lambda hi, ho: _ALL_GATHER(ho[0], hi[0], group=group),
                [xm], [out])
    else:
        _ALL_GATHER(out, xm, group=group)
    return out.movedim(0, dim)


def _psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0
                  ) -> torch.Tensor:
    group = _group(mesh, axis)
    n = axis_size(mesh, axis)
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dim {dim} of size {xm.shape[0]} not divisible "
                         f"by {axis} axis {n}")
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if _how("psum_scatter", group, xm) == "gloo-staged":
        _staged(lambda hi, ho: _REDUCE_SCATTER(ho[0], hi[0], group=group),
                [xm], [out])
    else:
        _REDUCE_SCATTER(out, xm, group=group)
    return out.movedim(0, dim)


def _all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    group = _group(mesh, axis)
    n = axis_size(mesh, axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"split axis of size {x.shape[split_axis]} not "
                         f"divisible by {axis} axis {n}")
    # [n, ...] with the block index leading: chunk j is contiguous
    xs = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(xs)
    if _how("all_to_all", group, xs) == "gloo-staged":
        _staged(lambda hi, ho: dist.all_to_all_single(ho[0], hi[0],
                                                      group=group),
                [xs], [out])
    else:
        dist.all_to_all_single(out, xs, group=group)
    return torch.cat(list(out.unbind(0)), dim=concat_axis)


# ---------------------------------------------------------------------------
# the differentiable collectives
# ---------------------------------------------------------------------------

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, [(d, s) for s, d in perm])
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, *ctx.args), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, *ctx.args), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, *ctx.args), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _psum_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, concat_axis, split_axis)
        return _all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: the (source, destination) pairs of ``perm``
    are coordinates along ``axis``; a rank that receives nothing gets
    zeros.  One ``batch_isend_irecv`` posts this rank's send and receive
    together.  Backward: the cotangent goes back by the inverse pairs."""
    return _PPermute.apply(x, mesh, axis, list(perm))


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.psum``: the sum over ``axis`` in ``x``'s dtype, on every
    member (``all_reduce``).  A region's exit: the backward is the
    identity (module docstring)."""
    return _Psum.apply(x, mesh, axis)


def enter(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A region's entry over ``axis`` (Megatron's "copy to region"): the
    identity forward, a ``psum`` of the cotangent backward."""
    return _Enter.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)``: the members' blocks
    concatenated along ``dim`` in coordinate order.  Backward: the
    cotangent reduce-scattered along ``dim``."""
    return _AllGather.apply(x, mesh, axis, dim)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0
                 ) -> torch.Tensor:
    """``jax.lax.psum_scatter(..., tiled=True)``: the sum over ``axis``,
    of which member i keeps block i along ``dim`` (reduce-scatter).
    Backward: the cotangent all-gathered along ``dim``."""
    return _PsumScatter.apply(x, mesh, axis, dim)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``x`` is cut into n blocks
    along ``split_axis``; block j goes to member j, and the blocks a member
    receives are concatenated along ``concat_axis`` in source order
    (``all_to_all_single`` on contiguous chunks).  Backward: the
    cotangent by ``all_to_all`` with the two axes swapped."""
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def barrier(device: torch.device) -> None:
    """Every rank of the default group waits for the others (a one-element
    ``all_reduce`` on ``device``, so it takes the same transport as the
    programs' collectives)."""
    t = torch.zeros(1, device=device)
    if _how("barrier", None, t) == "gloo-staged":
        _staged(lambda hi, ho: dist.all_reduce(hi[0]), [t], [])
    else:
        dist.all_reduce(t)


# A served group's host traffic (serve/group.py): the call's header, its
# numpy payload and the closing exchange, over host (gloo) groups of every
# rank, rank 0 the source.

def broadcast_object(obj, group):
    """Rank 0's picklable ``obj`` on every rank of ``group``."""
    box = [obj]
    _record("broadcast_object", "gloo")
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def broadcast_host(x: torch.Tensor, group) -> None:
    """Rank 0's host tensor ``x`` into ``x`` on every rank of ``group``."""
    _record("broadcast", "gloo")
    dist.broadcast(x, src=0, group=group)


def all_gather_object(obj, group) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    out = [None] * dist.get_world_size(group)
    _record("all_gather_object", "gloo")
    dist.all_gather_object(out, obj, group=group)
    return out


PROBE_KINDS = ("all_reduce", "broadcast", "all_gather", "psum_scatter",
               "all_to_all", "ppermute")


def probe_gloo_cuda(device: torch.device, kind: str) -> str:
    """Call one collective kind on a CUDA tensor straight through the
    default (gloo) group, without staging: ``"ok"``, or the error it
    raised.  For the record of what gloo takes on the card (a refusal can
    also abort the process, so each kind gets its own ranks); the
    transport rule above does not read it."""
    rank, n = dist.get_rank(), dist.get_world_size()
    x = torch.full((n * 4,), float(rank + 1), device=device)
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: _ALL_GATHER(
            torch.empty(n * x.numel(), device=device), x),
        "psum_scatter": lambda: _REDUCE_SCATTER(
            torch.empty(4, device=device), x),
        "all_to_all": lambda: dist.all_to_all_single(torch.empty_like(x), x),
        "ppermute": lambda: [w.wait() for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, (rank + 1) % n),
            dist.P2POp(dist.irecv, torch.empty_like(x), (rank - 1) % n)])],
    }
    try:
        tries[kind]()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return "ok"
    except (RuntimeError, ValueError, TypeError) as e:
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
