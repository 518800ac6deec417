"""The collectives' backward passes on rank groups (CPU, gloo).

Each rank feeds its input through one collective of
``parallel/collectives.py`` and takes the gradient of its share of a global
loss, ``sum(w_rank * y_rank)``; the same global function is differentiated
here in one process, with the collective written out on the stacked
inputs.  Held to atol 1e-6 in f32 and f64 on 2 and 4 ranks spawned by
``parallel.dryrun.launch``, for ``all_gather`` (along two dims),
``psum_scatter``, ``ppermute`` (a ring and a partial permutation),
``all_to_all``, the region's exit ``psum`` and its entry ``enter``.  A
missing reduction or a factor of the axis size in a backward fails here.

The exit and the entry are Megatron's pair: the exit's loss is one copy of
a value every rank computes alike (the same weights on every rank), the
entry's input one value every rank holds alike.
"""

import numpy as np
import pytest
import torch

from avd_tpu_torch.parallel import dryrun
from tests.torch_rank_programs import GRAD_KINDS

ATOL = 1e-6
WORLDS = (2, 4)
_DT = {"f32": np.float32, "f64": np.float64}


def _outputs(kind, X, n):
    """Every rank's output of the collective, written out on the stacked
    inputs ``X`` [n, ...]."""
    if kind == "enter":  # one value, used by every rank
        ys = [X[0]] * n
    elif kind == "psum":
        ys = [X.sum(0)] * n
    elif kind.startswith("all_gather"):
        ys = [torch.cat(list(X), dim=int(kind[-1]))] * n
    elif kind == "psum_scatter":
        ys = list(X.sum(0).chunk(n, dim=0))
    elif kind == "ppermute":
        ys = [X[(r - 1) % n] for r in range(n)]
    elif kind == "ppermute_partial":
        ys = [X[0] if r == 1 % n else torch.zeros_like(X[0])
              for r in range(n)]
        if n == 1:
            ys = [X[0]]
    elif kind == "all_to_all":
        ys = [torch.cat([X[s].chunk(n, dim=0)[r] for s in range(n)], dim=1)
              for r in range(n)]
    else:
        raise ValueError(kind)
    return ys


def _global(kind, X, W, n):
    """(gradient of the global loss with respect to every rank's input,
    every rank's output), in one process."""
    X = torch.from_numpy(X).requires_grad_(True)
    W = torch.from_numpy(W)
    ys = _outputs(kind, X, n)
    if kind == "psum":  # the exit: one loss, the same on every rank
        loss = (W[0] * ys[0]).sum()
    else:
        loss = sum((W[r] * ys[r]).sum() for r in range(n))
    (g,) = torch.autograd.grad(loss, X)
    if kind == "enter":
        g = g[:1].expand(n, *g.shape[1:])
    return g.numpy(), [y.detach().numpy() for y in ys]


def _inputs(n):
    rng = np.random.default_rng(n)
    out = {}
    for dt, np_dt in _DT.items():
        X = rng.standard_normal((n, 2 * n, 3)).astype(np_dt)
        out[f"x_{dt}"] = X
        for kind in GRAD_KINDS:
            shape = tuple(_outputs(kind, torch.from_numpy(X), n)[0].shape)
            W = rng.standard_normal((n,) + shape).astype(np_dt)
            if kind == "psum":
                W[:] = W[0]
            out[f"w_{kind}_{dt}"] = W
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world size spawned once: (inputs, every rank's report)."""
    work = tmp_path_factory.mktemp("collective_grads")
    out = {}
    for n in WORLDS:
        inputs = _inputs(n)
        out[n] = inputs, dryrun.launch(
            n, "cpu", [{"name": "grads",
                        "kind": "tests.torch_rank_programs:collective_grads"}],
            inputs=inputs, spec={}, timeout_s=300, workdir=str(work))
    return out


@pytest.mark.parametrize("dt", sorted(_DT))
@pytest.mark.parametrize("kind", GRAD_KINDS)
@pytest.mark.parametrize("n", WORLDS)
def test_backward_is_the_global_gradient(runs, n, kind, dt):
    inputs, ranks = runs[n]
    want_g, want_y = _global(kind, inputs[f"x_{dt}"],
                             inputs[f"w_{kind}_{dt}"], n)
    for r, rep in enumerate(ranks):
        got = rep["programs"]["grads"]["outputs"]
        np.testing.assert_allclose(got[f"{kind}_{dt}_y"], want_y[r],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[f"{kind}_{dt}"], want_g[r],
                                   atol=ATOL, rtol=0, err_msg=f"rank {r}")


# the collective each backward calls, counted under its own kind
BACKWARD_CALLS = {"all_gather0": "psum_scatter", "all_gather1": "psum_scatter",
                  "psum_scatter": "all_gather", "ppermute": "ppermute",
                  "ppermute_partial": "ppermute", "all_to_all": "all_to_all",
                  "enter": "psum", "psum": None}


@pytest.mark.parametrize("n", WORLDS)
def test_backward_calls_are_counted(runs, n):
    for rep in runs[n][1]:
        info = rep["programs"]["grads"]["info"]
        for kind, called in BACKWARD_CALLS.items():
            got = {k: v for k, v in info[f"{kind}_f32"].items()
                   if k != "staged" and v}
            assert got == ({} if called is None else {f"{called}/gloo": 1}), \
                (kind, got)
        # under no_grad the entry moves nothing and calls nothing
        assert {k: v for k, v in info["enter_no_grad_f32"].items()
                if v} == {}
