"""Pipeline parallelism (GPipe schedule) over a ``stage`` mesh dim.

Port of ``avd_tpu/parallel/pipeline.py``: each rank of the ``stage`` dim
holds ``depth/S`` layers of the stacked parameter tree, and microbatches
flow stage to stage by ``ppermute``.  Tick ``t`` has stage ``k`` on
microbatch ``t - k``; the pipeline drains after ``n_micro + S - 1`` ticks
(bubble ``(S-1)/(n_micro + S - 1)``).  ``avd_tpu`` runs the ticks as one
``lax.scan`` in which every stage computes on every tick; here a stage
computes only on its ``n_micro`` real ticks and hands zeros on the
others, which changes no output.

The backward pass (``avd_tpu`` differentiates the scan: the ``ppermute``
transposes to the reverse ring) is the same schedule run backwards, written
out in ``_GPipe``: the forward keeps each microbatch's graph on its stage;
the backward walks the ticks in reverse, each stage taking its
microbatch's gradient by autograd and handing the gradient of its input to
the stage before it by ``ppermute`` over the inverse ring, so every rank
calls the same collectives in the same order whatever its stage computes.
The last stage's buffer reaches every stage through a masked ``psum``, a
region's exit: its cotangent, the same on every stage, goes to the last
stage's outputs unchanged.  ``xs`` is replicated and read by stage 0 alone,
so it enters as a region's entry: its gradient is summed over ``stage``
and every stage gets the whole of it (the embedding's gradient is then the
same on every stage, not on stage 0 alone).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from avd_tpu_torch.parallel import collectives as col


def _tmap(fn, *trees):
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tmap(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _ring(n_stages: int):
    return [(i, (i + 1) % n_stages) for i in range(n_stages)]


def _forward(stage_fn, stage_params, xs, single, n_stages, mesh, axis,
             keep=None):
    """The forward ticks → the last stage's ``[n_micro, ...]`` outputs
    (zeros on the other stages), a tuple with a leaf per leaf of ``xs``
    (``single``: ``stage_fn`` takes and returns one tensor).  ``keep`` (a
    list) receives each microbatch this stage ran as (inputs, outputs),
    each input a leaf of its own graph."""
    n_micro = xs[0].shape[0]
    sid = col.axis_index(mesh, axis)
    ticks = n_micro + n_stages - 1
    state = tuple(torch.zeros_like(a[0]) for a in xs)
    outs: List[Any] = [None] * n_micro
    for t in range(ticks):
        mb = t - sid  # the microbatch this stage holds on this tick
        if 0 <= mb < n_micro:
            cur = tuple(a[mb] for a in xs) if sid == 0 else state
            if keep is not None:
                cur = tuple(c.detach().requires_grad_(c.is_floating_point())
                            for c in cur)
            y = stage_fn(stage_params, cur[0] if single else cur)
            y = (y,) if single else tuple(y)
            if keep is not None:
                keep.append((mb, cur, y))
                y = tuple(a.detach() for a in y)
            if sid == n_stages - 1:
                outs[mb] = y
        else:
            y = tuple(torch.zeros_like(a) for a in state)
        if t < ticks - 1:  # the last tick's hand-off reaches no stage
            state = tuple(col.ppermute(a, mesh, axis, _ring(n_stages))
                          for a in y)
    if sid != n_stages - 1:
        return tuple(torch.zeros_like(a) for a in xs)
    return tuple(torch.stack([o[i] for o in outs]) for i in range(len(xs)))


class _GPipe(torch.autograd.Function):
    """``gpipe`` with its backward schedule (module docstring).  Inputs:
    the leaves of ``xs`` then the stage parameters' leaves."""

    @staticmethod
    def forward(ctx, stage_fn, keys, n_x, single, n_stages, mesh, axis,
                *tensors):
        xs = tensors[:n_x]
        with torch.enable_grad():
            params = {k: v.detach().requires_grad_(v.requires_grad)
                      for k, v in zip(keys, tensors[n_x:])}
            runs: List[Any] = []
            out = _forward(stage_fn, params, xs, single, n_stages, mesh,
                           axis, runs)
        ctx.runs, ctx.params = runs, [params[k] for k in keys]
        ctx.meta = (n_stages, mesh, axis, [a.shape for a in xs],
                    [a.dtype for a in xs], xs[0].device)
        return tuple(col.psum(a, mesh, axis) for a in out)

    @staticmethod
    def backward(ctx, *g_out):
        n_stages, mesh, axis, shapes, dtypes, dev = ctx.meta
        sid = col.axis_index(mesh, axis)
        n_micro = shapes[0][0]
        ticks = n_micro + n_stages - 1
        inverse = [(d, s) for s, d in _ring(n_stages)]
        runs = {mb: (inp, out) for mb, inp, out in ctx.runs}
        g_params = [torch.zeros_like(p) for p in ctx.params]
        g_xs = [torch.zeros(s, dtype=d, device=dev)
                for s, d in zip(shapes, dtypes)]
        zeros = [torch.zeros(s[1:], dtype=d, device=dev)
                 for s, d in zip(shapes, dtypes)]
        recv = None
        for t in reversed(range(ticks)):
            mb = t - sid
            if mb in runs:
                inp, out = runs[mb]
                last = sid == n_stages - 1
                g_y = tuple(g[mb] for g in g_out) if last else recv
                wrt = list(inp) + [p for p in ctx.params if p.requires_grad]
                gs = torch.autograd.grad(out, wrt, grad_outputs=g_y,
                                         allow_unused=True)
                send = [z if g is None else g
                        for g, z in zip(gs[:len(inp)], zeros)]
                trained = iter(gs[len(inp):])
                for k, p in enumerate(ctx.params):
                    if p.requires_grad:
                        g = next(trained)
                        if g is not None:
                            g_params[k] += g
                if sid == 0:
                    for buf, g in zip(g_xs, send):
                        buf[mb] = g
            else:
                send = zeros
            if t > 0:
                recv = tuple(col.ppermute(g, mesh, axis, inverse)
                             for g in send)
        ctx.runs = ctx.params = None
        # xs entered the region: its gradient summed over the stages
        g_xs = [col.psum(g, mesh, axis) for g in g_xs]
        return (None,) * 7 + tuple(g_xs) + tuple(g_params)


def gpipe(stage_fn: Callable[[Any, Any], Any], stage_params: Dict[str, Any],
          xs: Any, n_stages: int, mesh, axis: str = "stage") -> Any:
    """Run the ``xs`` microbatches through the stage pipeline.

    Args:
        stage_fn: ``(stage_params, x) -> y``, this rank's slice of the
            network (a loop over its layers); shape-preserving.
        stage_params: this rank's stage of the stacked parameters (a dict
            of tensors).
        xs: ``[n_micro, ...]`` stacked microbatches, the same on every
            stage; a tensor or a tuple of tensors, every leaf riding the
            ring beside the activations (the MoE pre-gating features,
            which each stage's routers read and none rewrites).
        n_stages: the stage count (the mesh dim's size).

    Returns ``[n_micro, ...]`` outputs of the same structure, on every
    stage (a masked ``psum`` of the last stage's buffer).  Differentiable
    in ``xs`` and ``stage_params`` when autograd records them.
    """
    single = not isinstance(xs, tuple)
    leaves = (xs,) if single else tuple(xs)
    keys = list(stage_params)
    tensors = leaves + tuple(stage_params[k] for k in keys)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        out = _GPipe.apply(stage_fn, keys, len(leaves), single, n_stages,
                           mesh, axis, *tensors)
    else:
        out = tuple(col.psum(a, mesh, axis) for a in _forward(
            stage_fn, stage_params, leaves, single, n_stages, mesh, axis))
    return out[0] if single else tuple(out)


def stack_layers(layers: List[Dict[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """List of layer dicts → one dict of leaves with a leading layer axis,
    the layout a stage slices with ``("stage", ...)``."""
    return {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}


def scan_layers(layer_fn: Callable[[torch.Tensor, Dict], torch.Tensor],
                stacked: Dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """Apply ``layer_fn`` over a stacked layer dict, layer by layer (a loop
    where ``avd_tpu`` scans)."""
    n = next(iter(stacked.values())).shape[0]
    for i in range(n):
        x = layer_fn(x, {k: v[i] for k, v in stacked.items()})
    return x
