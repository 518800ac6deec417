"""ZeRO-1 and FSDP over the ``data`` axis, and the data-parallel update.

Port of ``avd_tpu/parallel/zero.py``.  ``avd_tpu`` gives the optimizer
state (ZeRO-1) or the parameters themselves (ZeRO-3/FSDP) a sharding
whose free dimension is split over ``data`` and lets XLA place the
collectives.  Here a rank holds its slices and the dataflow GSPMD derives
is written out:

* every mode: each rank takes the loss on its ``data`` slice of the batch
  and the step averages over ``data`` (the batch divides evenly, so the
  mean of the ranks' means is the global batch's mean);
* ``replicated`` (the dp × tp step): the gradients are all-reduced over
  ``data`` and divided by ``|data|``, and every data rank runs AdamW on
  its (tensor-parallel) leaves;
* ``zero1``: the AdamW moments (and the accumulation buffers, as
  ``optax.MultiSteps`` shards them in ``avd_tpu``) live as this rank's
  slice along the leaf's ZeRO dimension (``zero_spec``).  A step
  reduce-scatters the gradients over ``data`` along that dimension
  (divided by ``|data|``), runs AdamW on the slices and all-gathers the
  updated parameter slices.  A leaf whose spec stays unchanged takes the
  all-reduce path;
* ``fsdp``: the parameters are stored as their ``fsdp_param_specs``
  slices.  The forward all-gathers them before each use
  (``gather_leaves``; per block, recomputed in the backward pass, so a
  gathered copy lives for one block), and the backward of that
  ``all_gather`` is the reduce-scatter ZeRO-3 wants, each data rank's
  cotangent being its own.  AdamW runs on the slices.

Global-norm clipping sees the logical tree: each leaf's sum of squares is
summed over the axes that shard it in the layout the optimizer sees, and a
leaf every member of an axis holds alike is counted once
(``DataParallel.sq_sum``).  ``optim.AdamW``'s state layout (``count``,
``mu``, ``nu``, ``mini_step``, ``acc``) is unchanged: its lists hold the
slices this rank updates.

A ``Layout`` says where each leaf of a family's tree lives on a rank
(tensor parallelism, pipeline stages, FSDP) and moves whole trees in and
out of it; ``shard_opt_state`` and ``gather_opt_state`` do the same for an
optimizer state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from avd_tpu_torch.models import optim
from avd_tpu_torch.parallel import collectives as col
from avd_tpu_torch.parallel import mesh as mesh_mod

MODES = ("replicated", "zero1", "fsdp")


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", leaf))


def zero_spec(spec: Tuple, shape, data_size: int,
              axis: str = "data") -> Tuple:
    """A parameter's spec with its largest free dimension divisible by
    ``data_size`` split over ``axis`` (ties to the leading dimension); the
    spec unchanged when it already names ``axis`` or no free dimension
    divides (that leaf stays replicated over ``axis``, not padded)."""
    shape = _shape(shape)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if axis in entries:
        return spec
    best, best_dim = -1, -1
    for i, (e, n) in enumerate(zip(entries, shape)):
        if e is None and n % data_size == 0 and n > best:
            best, best_dim = n, i
    if best_dim < 0:
        return spec
    entries[best_dim] = axis
    return tuple(entries)


def _paths(tree, prefix: Tuple = ()):
    """(path, leaf) in ``optim.leaves_of`` order; a path holds dict keys
    and list indices."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def spec_leaves(specs) -> List[Tuple]:
    """The specs of a spec tree in ``optim.leaves_of`` order (a family's
    ``param_specs`` keeps its ``param_shapes``' key order, so this is the
    order of its parameters' leaves)."""
    return [s for _, s in _paths(specs)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def zero1_param_specs(params, specs, data_size: int,
                      axis: str = "data") -> Dict[Tuple, Tuple]:
    """``{parameter path: ZeRO-extended spec}`` for every parameter
    (``params`` may hold tensors or shapes)."""
    return {path: zero_spec(_at(specs, path), leaf, data_size, axis)
            for path, leaf in _paths(params)}


def fsdp_param_specs(params, specs, data_size: int, axis: str = "data"):
    """A spec tree of ``params``' structure whose every leaf's largest free
    dimension is split over ``axis`` on top of its tensor-parallel spec."""
    return optim.unflatten(params, list(zero1_param_specs(
        params, specs, data_size, axis).values()))


def gather_leaves(tree, specs, mesh, axis: str = "data"):
    """FSDP's gather before use: each leaf whose spec names ``axis``
    all-gathered along that dimension (differentiable: its backward
    reduce-scatters the cotangent)."""
    def one(x, spec):
        for d, a in enumerate(spec):
            if a == axis:
                return col.all_gather(x, mesh, axis, dim=d)
        return x
    if isinstance(tree, dict):
        return {k: gather_leaves(v, specs[k], mesh, axis)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_leaves(v, s, mesh, axis) for v, s in zip(tree, specs)]
    return one(tree, specs)


@dataclasses.dataclass
class Layout:
    """Where each leaf of a family's tree lives on this rank: ``specs``
    cut the tree after ``permute`` (a reordering such as the ViT's
    head-major qkv columns, or the pipeline's stacked stages);
    ``unpermute`` undoes it."""
    mesh: Any
    specs: Any
    permute: Callable = lambda tree: tree
    unpermute: Callable = lambda tree: tree

    def shard(self, tree):
        """This rank's slices of a whole tree (on the tree's device)."""
        return mesh_mod.shard_params(self.mesh, self.permute(tree),
                                     self.specs)

    def gather(self, local):
        """The whole tree from every rank's slices, on every rank."""
        return self.unpermute(mesh_mod.gather_params(self.mesh, local,
                                                     self.specs))


def _dim_of(spec: Tuple, axis: str) -> Optional[int]:
    return spec.index(axis) if axis in spec else None


def _narrow(x: torch.Tensor, d: int, i: int, n: int) -> torch.Tensor:
    step = x.shape[d] // n
    return x.narrow(d, i * step, step).contiguous().clone()


def shard_opt_state(opt_state: Dict, params: List[torch.Tensor],
                    specs: List[Tuple], mesh, axis: str = "data") -> Dict:
    """ZeRO-1: an optimizer state over ``params`` (this rank's leaves, in
    ``optim.leaves_of`` order, with their ``specs``) with every moment and
    accumulation leaf cut to this rank's slice along its ZeRO dimension;
    counters and leaves whose spec stays unchanged are kept."""
    n = col.axis_size(mesh, axis)
    i = col.axis_index(mesh, axis)
    dims = [_dim_of(zero_spec(s, p, n, axis), axis) if axis not in s
            else None for p, s in zip(params, specs)]
    out = dict(opt_state)
    for key in ("mu", "nu", "acc"):
        if key in out:
            out[key] = [x if d is None else _narrow(x, d, i, n)
                        for x, d in zip(out[key], dims)]
    return out


def _psum_flat(xs: List[torch.Tensor], mesh, axis: str
               ) -> List[torch.Tensor]:
    """``psum`` of every tensor of ``xs`` in one call (one flat buffer)."""
    if not xs:
        return []
    flat = col.psum(torch.cat([x.reshape(-1) for x in xs]), mesh, axis)
    return [y.view_as(x) for y, x in
            zip(flat.split([x.numel() for x in xs]), xs)]


def _reduce_scatter_flat(xs: List[torch.Tensor], dims: List[int], mesh,
                         axis: str) -> List[torch.Tensor]:
    """Each ``xs[k]`` summed over ``axis``, this rank keeping its block
    along ``dims[k]``: one reduce-scatter of one buffer."""
    if not xs:
        return []
    n = col.axis_size(mesh, axis)
    moved = [x.movedim(d, 0) for x, d in zip(xs, dims)]
    buf = torch.cat([m.reshape(n, -1) for m in moved], dim=1)
    out = col.psum_scatter(buf, mesh, axis, dim=0)[0]
    parts = out.split([m.numel() // n for m in moved])
    return [p.reshape((m.shape[0] // n,) + tuple(m.shape[1:]))
            .movedim(0, d).contiguous()
            for p, m, d in zip(parts, moved, dims)]


def _all_gather_flat(xs: List[torch.Tensor], dims: List[int], mesh,
                     axis: str) -> List[torch.Tensor]:
    """Each ``xs[k]`` all-gathered over ``axis`` along ``dims[k]``: one
    all-gather of one buffer."""
    if not xs:
        return []
    n = col.axis_size(mesh, axis)
    moved = [x.movedim(d, 0) for x, d in zip(xs, dims)]
    buf = torch.cat([m.reshape(1, -1) for m in moved], dim=1)
    full = col.all_gather(buf, mesh, axis, dim=0)
    parts = full.split([m.numel() for m in moved], dim=1)
    return [p.reshape((n * m.shape[0],) + tuple(m.shape[1:])).movedim(0, d)
            for p, m, d in zip(parts, moved, dims)]


class DataParallel:
    """One rank's reduction of its gradients over ``axis`` and its
    optimizer update, in one of ``MODES`` (module docstring).

    ``specs`` are the specs of this rank's leaves as it stores them, in
    ``optim.leaves_of`` order: tensor-parallel (and stage) specs, and for
    ``fsdp`` the ``fsdp_param_specs`` that name ``axis`` too."""

    def __init__(self, optimizer, mesh, specs: List[Tuple],
                 mode: str = "replicated", axis: str = "data"):
        if mode not in MODES:
            raise ValueError(f"unknown data-parallel mode {mode!r}; "
                             f"choose from {list(MODES)}")
        self.optimizer, self.mesh, self.mode, self.axis = (
            optimizer, mesh, mode, axis)
        self.specs = [tuple(s) for s in specs]
        self.n = col.axis_size(mesh, axis)
        self.dims: Optional[List[Optional[int]]] = None

    def _zero_dims(self, leaves) -> List[Optional[int]]:
        if self.dims is None:
            self.dims = [
                _dim_of(zero_spec(s, p, self.n, self.axis), self.axis)
                if self.mode == "zero1" and self.axis not in s else None
                for p, s in zip(leaves, self.specs)]
        return self.dims

    def _view_specs(self, leaves) -> List[Tuple]:
        """The spec of each leaf the optimizer updates."""
        return [zero_spec(s, p, self.n, self.axis) if d is not None else s
                for p, s, d in zip(leaves, self.specs,
                                   self._zero_dims(leaves))]

    def init(self, leaves: List[torch.Tensor]) -> Dict:
        """A fresh optimizer state over this rank's share of ``leaves``."""
        return self.shard_state(self.optimizer.init(leaves), leaves)

    def shard_state(self, state: Dict, leaves) -> Dict:
        """A state over whole leaves (this rank's tensor-parallel
        layout) → over the slices this rank updates."""
        if self.mode != "zero1":
            return state
        return shard_opt_state(state, leaves, self.specs, self.mesh,
                               self.axis)

    def unshard_state(self, state: Dict, leaves) -> Dict:
        """The inverse of ``shard_state`` (a collective on every rank)."""
        if self.mode != "zero1":
            return state
        dims = self._zero_dims(leaves)
        out = dict(state)
        with torch.no_grad():
            for key in ("mu", "nu", "acc"):
                if key in out:
                    sl = [k for k, d in enumerate(dims) if d is not None]
                    full = _all_gather_flat([out[key][k] for k in sl],
                                            [dims[k] for k in sl],
                                            self.mesh, self.axis)
                    vals = list(out[key])
                    for k, x in zip(sl, full):
                        vals[k] = x.contiguous()
                    out[key] = vals
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of ``axis`` of a value every rank took
        on its slice (the step's loss)."""
        with torch.no_grad():
            return col.psum(x, self.mesh, self.axis) / self.n

    def reduce(self, leaves, grads: List[torch.Tensor]
               ) -> List[torch.Tensor]:
        """This rank's gradients → those of the global-batch mean, as the
        optimizer sees them (slices for ``zero1``'s sharded leaves)."""
        dims = self._zero_dims(leaves)
        grads = [g.float() for g in grads]
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        with torch.no_grad():
            if self.mode == "fsdp":  # sliced leaves: summed by the gather
                summed = [k for k, s in enumerate(self.specs)
                          if self.axis in s]
                for k in summed:
                    out[k] = grads[k]
            else:
                summed = []
            scatter = [k for k, d in enumerate(dims) if d is not None]
            for k, g in zip(scatter, _reduce_scatter_flat(
                    [grads[k] for k in scatter], [dims[k] for k in scatter],
                    self.mesh, self.axis)):
                out[k] = g
            rest = [k for k in range(len(grads)) if out[k] is None]
            for k, g in zip(rest, _psum_flat([grads[k] for k in rest],
                                             self.mesh, self.axis)):
                out[k] = g
            return [g / self.n for g in out]

    def sq_sum(self, leaves) -> Callable:
        """The squared global norm of the logical tree from this rank's
        optimizer-side gradients: each group of leaves sharded over the
        same axes summed, then ``psum``-ed over those axes; leaves held
        alike by every member of an axis counted once."""
        axes = [frozenset(a for a in s if a is not None)
                for s in self._view_specs(leaves)]

        def fn(grads: List[torch.Tensor]) -> torch.Tensor:
            groups: Dict[frozenset, List[torch.Tensor]] = {}
            for g, a in zip(grads, axes):
                groups.setdefault(a, []).append(g)
            total = None
            for a in sorted(groups, key=sorted):
                s = optim.sum_of_squares(groups[a])
                for name in sorted(a):
                    s = col.psum(s, self.mesh, name)
                total = s if total is None else total + s
            return total
        return fn

    def global_norm(self, leaves) -> torch.Tensor:
        """The global norm the clip takes of the last step's reduced
        gradients (``sq_sum``; a collective on every rank)."""
        with torch.no_grad():
            return torch.sqrt(self.sq_sum(leaves)(self.last_grads))

    def update(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict) -> bool:
        """Reduce this rank's ``grads`` and apply the optimizer to
        ``leaves`` in place; True when the parameters moved."""
        dims = self._zero_dims(leaves)
        grads = self.reduce(leaves, grads)
        self.last_grads = grads
        with torch.no_grad():
            view = [p if d is None else
                    _narrow(p, d, col.axis_index(self.mesh, self.axis),
                            self.n)
                    for p, d in zip(leaves, dims)]
            moved = self.optimizer.update(view, grads, state,
                                          sq_sum=self.sq_sum(leaves))
            sl = [k for k, d in enumerate(dims) if d is not None]
            if moved and sl:
                full = _all_gather_flat([view[k] for k in sl],
                                        [dims[k] for k in sl], self.mesh,
                                        self.axis)
                for k, x in zip(sl, full):
                    leaves[k].copy_(x)
        return moved

    def full_grads(self, leaves) -> List[torch.Tensor]:
        """The last step's reduced gradients over this rank's whole leaves
        (``zero1``'s slices all-gathered; a collective on every rank)."""
        dims = self._zero_dims(leaves)
        out = list(self.last_grads)
        sl = [k for k, d in enumerate(dims) if d is not None]
        with torch.no_grad():
            for k, x in zip(sl, _all_gather_flat(
                    [out[k] for k in sl], [dims[k] for k in sl], self.mesh,
                    self.axis)):
                out[k] = x.contiguous()
        return out


def zero1_train_step(family, cfg, optimizer, mesh, logit_l2: float = 0.0):
    """The counterpart of ``avd_tpu``'s ``zero1_jit_train_step``: the
    family's (ViT or CNN) dp × tp step with ZeRO-1 (its optimizer state
    from ``step.dp.init``, or ``shard_opt_state`` of a whole-leaf one)."""
    return family.make_train_step(cfg, optimizer, logit_l2=logit_l2,
                                  sharded=True, mesh=mesh, zero_mode="zero1")


def _state_trees(state: Dict):
    return [k for k in ("mu", "nu", "acc") if k in state]


def gather_opt_state(state: Dict, dp: DataParallel, layout: Layout,
                     local_leaves: List[torch.Tensor]) -> Dict:
    """A rank's optimizer state → the single-device state over the whole
    tree (a collective on every rank)."""
    state = dp.unshard_state(state, local_leaves)
    local_tree = optim.unflatten(layout.specs, local_leaves)
    out = dict(state)
    for key in _state_trees(state):
        tree = optim.unflatten(local_tree, state[key])
        out[key] = optim.leaves_of(layout.gather(tree))
    return out


def load_opt_state(state: Dict, dp: DataParallel, layout: Layout,
                   full_tree, local_leaves: List[torch.Tensor]) -> Dict:
    """A single-device optimizer state over the whole tree ``full_tree``
    → this rank's state (its layout's leaves, then its ZeRO slices)."""
    out = dict(state)
    for key in _state_trees(state):
        tree = optim.unflatten(full_tree, state[key])
        out[key] = [x.to(p.device) for x, p in zip(
            optim.leaves_of(layout.shard(tree)), local_leaves)]
    return dp.shard_state(out, local_leaves)
