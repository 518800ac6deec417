"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present.  Run
them on a GPU machine (which needs no jax) with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The shapes here are the awkward ones (widths off the 32-pixel tile, tiny
planes, a batch of one); ``chip_smoke.py`` covers the main path's shapes.
"""

import pytest
import torch

from avd_tpu_torch.ops import flow as flow_ops
from avd_tpu_torch.ops.kernels import blur_solve, warp

pytestmark = pytest.mark.cuda

_SHAPES = [(1, 2, 2), (3, 37, 53), (2, 40, 48), (1, 96, 33), (2, 5, 300)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("b,h,w", _SHAPES)
@pytest.mark.parametrize("scale", [0.0, 3.0, 40.0])
def test_warp_kernel_matches_plain(gen, b, h, w, scale):
    src = torch.rand((b, 5, h, w), generator=gen, device="cuda")
    fl = (torch.rand((b, 2, h, w), generator=gen, device="cuda") - 0.5) \
        * scale
    before = warp.LAUNCHES
    out = warp.warp_bilinear(src, fl)
    assert warp.LAUNCHES == before + 1
    ref = warp.warp_bilinear_plain(src, fl)
    _, inb = flow_ops._warp_poly(src, fl)
    inb = inb[:, None].expand_as(out)
    assert torch.allclose(out[inb], ref[inb], atol=1e-5, rtol=0)
    assert not out[~inb].any()


@pytest.mark.parametrize("b,h,w", _SHAPES)
def test_blur_solve_kernel_matches_plain(gen, b, h, w):
    r4, r5, r6, h1, h2 = torch.randn((5, b, h, w), generator=gen,
                                     device="cuda")
    m = torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                     h1, h2], dim=1).contiguous()
    before = blur_solve.LAUNCHES
    out = blur_solve.box_blur_solve(m)
    assert blur_solve.LAUNCHES == before + 1
    ref = blur_solve.box_blur_solve_plain(m)
    assert torch.allclose(out, ref, atol=2e-4, rtol=1e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    src = torch.rand((1, 5, 8, 8), generator=gen, device="cuda")
    fl = torch.zeros((1, 2, 8, 8), device="cuda")
    with pytest.raises(TypeError):
        warp.warp_bilinear(src.half(), fl)
    with pytest.raises(ValueError):
        warp.warp_bilinear(src.transpose(2, 3), fl)
    with pytest.raises(ValueError):
        warp.warp_bilinear(src, fl[:, :, :4])
    with pytest.raises(ValueError):
        blur_solve.box_blur_solve(src, winsize=9)
    with pytest.raises(ValueError):
        blur_solve.box_blur_solve(src[:, :4].contiguous())
