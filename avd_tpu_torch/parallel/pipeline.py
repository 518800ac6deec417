"""Pipeline parallelism (GPipe schedule) over a ``stage`` mesh dim.

Port of ``avd_tpu/parallel/pipeline.py`` (the forward): each rank of the
``stage`` dim holds ``depth/S`` layers of the stacked parameter tree, and
microbatches flow stage to stage by ``ppermute``.  Tick ``t`` has stage
``k`` on microbatch ``t - k``; the pipeline drains after ``n_micro + S -
1`` ticks (bubble ``(S-1)/(n_micro + S - 1)``).  ``avd_tpu`` runs the
ticks as one ``lax.scan`` in which every stage computes on every tick;
here a stage computes only on its ``n_micro`` real ticks and hands zeros
on the others, which changes no output.  The backward pass through the
pipeline belongs to the training slice (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from avd_tpu_torch.parallel import collectives as col


def _tmap(fn, *trees):
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tmap(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def gpipe(stage_fn: Callable[[Any, Any], Any], stage_params: Any, xs: Any,
          n_stages: int, mesh, axis: str = "stage") -> Any:
    """Run the ``xs`` microbatches through the stage pipeline.

    Args:
        stage_fn: ``(stage_params, x) -> y``, this rank's slice of the
            network (a loop over its layers); shape-preserving.
        stage_params: this rank's stage of the stacked parameters.
        xs: ``[n_micro, ...]`` stacked microbatches, the same on every
            stage; a tensor or a tuple of tensors, every leaf riding the
            ring beside the activations (the MoE pre-gating features,
            which each stage's routers read and none rewrites).
        n_stages: the stage count (the mesh dim's size).

    Returns ``[n_micro, ...]`` outputs of the same structure, on every
    stage (a masked ``psum`` of the last stage's buffer).
    """
    n_micro = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
    sid = col.axis_index(mesh, axis)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    ticks = n_micro + n_stages - 1
    state = _tmap(lambda a: torch.zeros_like(a[0]), xs)
    out = _tmap(torch.zeros_like, xs)
    for t in range(ticks):
        mb = t - sid  # the microbatch this stage holds on this tick
        if 0 <= mb < n_micro:
            cur = _tmap(lambda a: a[mb], xs) if sid == 0 else state
            y = stage_fn(stage_params, cur)
            if sid == n_stages - 1:
                _tmap(lambda buf, row: buf[mb].copy_(row), out, y)
        else:
            y = _tmap(torch.zeros_like, state)
        if t < ticks - 1:  # the last tick's hand-off reaches no stage
            state = _tmap(lambda a: col.ppermute(a, mesh, axis, perm), y)
    # replicate the last stage's buffer to every stage (one psum a leaf)
    if sid != n_stages - 1:
        out = _tmap(torch.zeros_like, out)
    return _tmap(lambda a: col.psum(a, mesh, axis), out)


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
