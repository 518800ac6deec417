"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present.  Run
them on a GPU machine (which needs no jax) with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The shapes here are the awkward ones (widths off the 32-pixel tile, tiny
planes, a batch of one, token counts at the edges of the 16-key tiles);
``chip_smoke.py`` covers the main path's shapes.
"""

import ctypes

import pytest
import torch

from avd_tpu_torch.ops import flow as flow_ops
from avd_tpu_torch.ops.kernels import attention, blur_solve, flow_iter, warp
from chip_smoke import (TILED_ULPS, _constant_m, _ulps_off,
                        _well_conditioned_m)

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


def _psd_m(gen, b, h, w):
    r4, r5, r6, h1, h2 = torch.randn((5, b, h, w), generator=gen,
                                     device="cuda")
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        h1, h2], dim=1).contiguous()


# the 32×8 tile (few blocks: the tail window's 40² level among them), the
# 32×40 tile (many), ragged edges of both
_BLUR_SHAPES = _SHAPES + [(2, 16, 16), (12, 320, 320), (12, 160, 160),
                          (12, 80, 80), (12, 40, 40), (48, 40, 40),
                          (48, 80, 80), (30, 160, 160), (40, 100, 150),
                          (900, 33, 17)]


@pytest.mark.parametrize("b,h,w", _BLUR_SHAPES)
def test_blur_solve_kernel_matches_plain(gen, b, h, w):
    m = _psd_m(gen, b, h, w)
    before = blur_solve.LAUNCHES
    out = blur_solve.box_blur_solve(m)
    assert blur_solve.LAUNCHES == before + 1
    ref = blur_solve.box_blur_solve_plain(m)
    assert torch.allclose(out, ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("b,h,w", [(3, 37, 53), (12, 320, 320),
                                   (12, 40, 40), (48, 40, 40)])
def test_blur_solve_kernel_keeps_the_plain_order_of_sums(gen, b, h, w):
    """Each 15-tap sum runs left to right from tap 0, rows before columns,
    and the solve is not contracted: the kernel equals the plain version
    bit for bit, on both tiles."""
    m = _psd_m(gen, b, h, w)
    assert torch.equal(blur_solve.box_blur_solve(m),
                       blur_solve.box_blur_solve_plain(m))


@pytest.mark.parametrize("b,h,w", _SHAPES + [(4, 320, 320), (3, 41, 67)])
@pytest.mark.parametrize("scale", [0.0, 3.0, 40.0])
def test_warp_kernel_equals_plain_in_both_types(gen, b, h, w, scale):
    """The float32 instance and the bf16 one (taps widened on load) each
    equal the plain version on the same input bit for bit; bf16 stays
    within its rounding (8e-3) of the float32 field's result."""
    src = torch.rand((b, 5, h, w), generator=gen, device="cuda")
    fl = (torch.rand((b, 2, h, w), generator=gen, device="cuda") - 0.5) \
        * scale
    before = dict(warp.DTYPE_LAUNCHES)
    out32 = warp.warp_bilinear(src, fl)
    out16 = warp.warp_bilinear(src.bfloat16(), fl)
    assert warp.DTYPE_LAUNCHES == {k: v + 1 for k, v in before.items()}
    assert out16.dtype == torch.float32
    assert torch.equal(out32, warp.warp_bilinear_plain(src, fl))
    assert torch.equal(out16, warp.warp_bilinear_plain(src.bfloat16(), fl))
    assert torch.allclose(out16, out32, atol=8e-3, rtol=8e-3)


# the bf16 tile's edges: W % 8 != 0 (every chunk through registers), W < 32,
# H below the 40-row tile, and tile counts that are no multiple of 132
_BF16_EDGES = [(3, 41, 67), (2, 24, 40), (5, 33, 20), (1, 57, 8),
               (7, 39, 250), (4, 40, 36), (13, 320, 328), (11, 100, 100)]


@pytest.mark.parametrize("b,h,w", _BLUR_SHAPES + _BF16_EDGES)
def test_blur_solve_kernel_bf16_within_the_tpu_contract(gen, b, h, w):
    """bf16 M, row sums on the tensor cores: the TPU kernel's contract
    ("semantically identical up to f32 accumulation order"), held as its
    tests hold it, at atol 2e-4 / rtol 1e-3 against the plain version on
    positive-semidefinite fields, on both tiles, aligned (W % 8 == 0) and
    not."""
    m = _psd_m(gen, b, h, w).bfloat16()
    before = dict(blur_solve.DTYPE_LAUNCHES)
    out = blur_solve.box_blur_solve(m)
    assert blur_solve.DTYPE_LAUNCHES == {**before,
                                         "bfloat16": before["bfloat16"] + 1}
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, blur_solve.box_blur_solve_plain(m),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("field", [_well_conditioned_m, _constant_m])
@pytest.mark.parametrize("b,h,w", [(1, 80, 96), (1, 40, 136), (3, 41, 67),
                                   (48, 40, 40), (12, 320, 320)])
def test_blur_solve_kernel_bf16_exact_cases(gen, field, b, h, w):
    """On a well-conditioned field and on a constant one (every sum on the
    replicate edge) the bf16 kernel holds the plain version at 1e-6, as
    the TPU kernel's tests hold it."""
    m = field(gen, b, h, w).bfloat16()
    before = blur_solve.LAUNCHES
    out = blur_solve.box_blur_solve(m)
    assert blur_solve.LAUNCHES == before + 1
    torch.testing.assert_close(out, blur_solve.box_blur_solve_plain(m),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("b,h,w,y,x", [(12, 120, 136, 60, 70),
                                       (2, 41, 67, 20, 33)])
def test_blur_solve_kernel_bf16_bounds_a_non_finite_m(gen, b, h, w, y, x):
    """One Inf in bf16 M: the plain version, as the TPU kernel, makes the
    outputs whose 15×15 window holds it non-finite.  The kernel's band
    product (0·Inf) and running column sums spread it further, but only
    to rows y − 7 … y + 7 + KV − 1 (KV <= 5) and columns x − 23 … x + 23
    of its image; every other output holds the plain version.  Both
    tiles: 180 and 12 blocks of 32×40."""
    m = _psd_m(gen, b, h, w).bfloat16()
    m[0, 0, y, x] = float("inf")
    out = blur_solve.box_blur_solve(m)
    ref = blur_solve.box_blur_solve_plain(m)
    bad, bad_ref = ~out.isfinite().all(1), ~ref.isfinite().all(1)
    assert bad_ref.any() and bool((bad | ~bad_ref).all())
    box = torch.zeros_like(bad)
    box[0, max(y - 7, 0):y + 12, max(x - 23, 0):x + 24] = True
    assert not bool((bad & ~box).any())
    torch.testing.assert_close(out.masked_fill(box[:, None], 0),
                               ref.masked_fill(box[:, None], 0),
                               atol=2e-4, rtol=1e-3)


def test_blur_solve_kernel_bf16_within_rounding_of_f32(gen):
    """On a well-conditioned M (``tests/test_flow_bf16.py``'s) bf16
    storage moves the flow by at most 2e-2."""
    g = torch.rand((5, 2, 80, 80), generator=gen, device="cuda")
    m = torch.stack([g[0] + 1.0, (g[1] - 0.5) * 0.2, g[2] + 1.0,
                     (g[3] - 0.5) * 2.0, (g[4] - 0.5) * 2.0],
                    dim=1).contiguous()
    assert torch.allclose(blur_solve.box_blur_solve(m.bfloat16()),
                          blur_solve.box_blur_solve(m), atol=2e-2,
                          rtol=2e-2)


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


def _update_fields(gen, b, h, w, scale, dtype):
    R0 = torch.randn((b, 5, h, w), generator=gen, device="cuda").to(dtype)
    R1 = torch.randn((b, 5, h, w), generator=gen, device="cuda").to(dtype)
    fl = (torch.rand((b, 2, h, w), generator=gen, device="cuda") - 0.5) \
        * scale
    return R0, R1, fl


def _bits(x):
    """x's float32 bit patterns, every NaN as one."""
    return torch.where(x.isnan(), float("nan"), x).view(torch.int32)


_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", _DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [48, 12])
@pytest.mark.parametrize("h", [320, 160, 80, 40])
@pytest.mark.parametrize("scale", [3.0, 40.0])
def test_warp_update_equals_the_plain_composition(gen, dtype, b, h, scale):
    """The warp with the update epilogue forms M in the plain version's
    order, uncontracted: bit for bit ``update_from_warped`` after the
    plain warp, at the window's levels, full (48 pairs) and tail (12), in
    both field types; at scale 40 most pixels leave the image."""
    R0, R1, fl = _update_fields(gen, b, h, h, scale, dtype)
    out = warp.warp_update(R0, R1, fl)
    assert out.dtype == torch.float32 and out.shape == (b, 5, h, h)
    assert torch.equal(out, warp.warp_update_plain(R0, R1, fl))
    assert torch.equal(out, flow_ops.update_from_warped(
        R0, warp.warp_bilinear_plain(R1, fl), fl))


@pytest.mark.parametrize("dtype", _DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [2, 7, 9, 10, 11])
@pytest.mark.parametrize("w", [2, 7, 9, 10, 11])
def test_warp_update_where_the_taper_bands_meet(gen, dtype, h, w):
    """Under 10 px the taper bands of opposite edges meet and both factors
    apply, as in ``_border_taper``'s product; 2 px is the smallest plane
    the in-bounds rule leaves a pixel in."""
    R0, R1, fl = _update_fields(gen, 3, h, w, 2.0, dtype)
    assert torch.equal(warp.warp_update(R0, R1, fl),
                       warp.warp_update_plain(R0, R1, fl))


@pytest.mark.parametrize("dtype", _DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w", _SHAPES)
def test_warp_update_on_flow_out_of_bounds_and_nan(gen, dtype, b, h, w):
    """A pan past the image on both sides, and NaN flow planted on a third
    of the pixels (each plane alone and both): every pixel out of bounds
    keeps R0's terms, NaN flow gives NaN where the plain version does, and
    the rest is the plain version bit for bit."""
    R0, R1, fl = _update_fields(gen, b, h, w, 3.0, dtype)
    for shift in (500.0, -500.0, 61.3):
        pan = torch.full_like(fl, shift)
        assert torch.equal(warp.warp_update(R0, R1, pan),
                           warp.warp_update_plain(R0, R1, pan))
    planted = fl.clone()
    third = torch.rand((b, h, w), generator=gen, device="cuda") < 1 / 3
    planted[:, 0][third] = float("nan")
    planted[:, 1][third.roll(1, -1)] = float("nan")
    out = warp.warp_update(R0, R1, planted)
    ref = warp.warp_update_plain(R0, R1, planted)
    assert ref.isnan().any()
    assert torch.equal(_bits(out), _bits(ref))


def test_warp_update_refuses_what_the_kernel_does_not_take(gen):
    R0, R1, fl = _update_fields(gen, 1, 8, 8, 1.0, torch.float32)
    with pytest.raises(TypeError):
        warp.warp_update(R0.half(), R1.half(), fl)
    with pytest.raises(TypeError):
        warp.warp_update(R0, R1.bfloat16(), fl)
    with pytest.raises(TypeError):
        warp.warp_update(R0, R1, fl.double())
    with pytest.raises(ValueError):
        warp.warp_update(R0[:, :4].contiguous(), R1[:, :4].contiguous(), fl)
    with pytest.raises(ValueError):
        warp.warp_update(R0, R1[..., :4].contiguous(), fl)
    with pytest.raises(ValueError):
        warp.warp_update(R0, R1, fl[..., :4].contiguous())
    with pytest.raises(ValueError):
        warp.warp_update(R0[..., :1].contiguous(), R1[..., :1].contiguous(),
                         fl[..., :1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        warp.warp_update(R0.transpose(2, 3), R1, fl)
    with pytest.raises(ValueError, match="contiguous"):
        warp.warp_update(R0, R1, fl.transpose(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        warp.warp_update(R0.cpu(), R1, fl)
    with pytest.raises(ValueError, match="CUDA"):
        warp.warp_update(R0, R1, fl.cpu())


@pytest.mark.parametrize("dtype", _DTYPES, ids=["f32", "bf16"])
def test_warp_update_counts_each_launch_once(gen, dtype):
    """A launch of the update instance is one warp launch, counted once
    in ``LAUNCHES``, under its field type and under ``update``; the plain
    warp counts under ``warp``."""
    R0, R1, fl = _update_fields(gen, 2, 40, 48, 3.0, dtype)
    name = str(dtype).replace("torch.", "")
    counts = (warp.LAUNCHES, dict(warp.DTYPE_LAUNCHES),
              dict(warp.VARIANT_LAUNCHES), blur_solve.LAUNCHES)
    warp.warp_update(R0, R1, fl)
    assert (warp.LAUNCHES, warp.DTYPE_LAUNCHES, warp.VARIANT_LAUNCHES,
            blur_solve.LAUNCHES) == (
        counts[0] + 1, {**counts[1], name: counts[1][name] + 1},
        {**counts[2], "update": counts[2]["update"] + 1}, counts[3])
    warp.warp_update_plain(R0, R1, fl)
    warp.warp_bilinear(R1, fl)
    assert (warp.LAUNCHES, warp.DTYPE_LAUNCHES, warp.VARIANT_LAUNCHES) == (
        counts[0] + 2, {**counts[1], name: counts[1][name] + 2},
        {"warp": counts[2]["warp"] + 1, "update": counts[2]["update"] + 1})


@pytest.mark.parametrize("dtype", _DTYPES, ids=["f32", "bf16"])
def test_a_flow_window_launches_the_update_instance_every_round(gen, dtype):
    """``farneback_flow``'s unfused rounds are each one warp launch with
    the update epilogue and one blur+solve: 12 of each for the 4 levels of
    a 320² pair, none of the plain warp; the fused round takes none."""
    prev = torch.rand((2, 320, 320), generator=gen, device="cuda") * 255
    cur = prev.roll((2, 3), (1, 2))
    counts = (dict(warp.VARIANT_LAUNCHES), blur_solve.LAUNCHES,
              flow_iter.LAUNCHES)
    flow_ops.farneback_flow(prev, cur, flow_bf16=dtype == torch.bfloat16)
    assert (warp.VARIANT_LAUNCHES, blur_solve.LAUNCHES,
            flow_iter.LAUNCHES) == (
        {**counts[0], "update": counts[0]["update"] + 12},
        counts[1] + 12, counts[2])
    flow_ops.farneback_flow(prev, cur, fused_iter=True)
    assert (warp.VARIANT_LAUNCHES, blur_solve.LAUNCHES) == (
        {**counts[0], "update": counts[0]["update"] + 12}, counts[1] + 12)


@pytest.mark.parametrize("b,h,w", [(1, 16, 16), (3, 37, 53), (2, 40, 48),
                                   (1, 96, 33), (2, 17, 300), (2, 160, 160)])
@pytest.mark.parametrize("scale", [0.0, 3.0, 40.0])
def test_flow_iter_kernel_matches_plain(gen, b, h, w, scale):
    R0 = torch.randn((b, 5, h, w), generator=gen, device="cuda")
    R1 = torch.randn((b, 5, h, w), generator=gen, device="cuda")
    fl = (torch.rand((b, 2, h, w), generator=gen, device="cuda") - 0.5) \
        * scale
    counts = (warp.LAUNCHES, blur_solve.LAUNCHES, flow_iter.LAUNCHES)
    out = flow_iter.solve_iteration(R0, R1, fl)
    assert (warp.LAUNCHES, blur_solve.LAUNCHES, flow_iter.LAUNCHES) == \
        (counts[0], counts[1], counts[2] + 1)
    ref = flow_iter.solve_iteration_plain(R0, R1, fl)
    # the plain version launches none of the three kernels
    assert (warp.LAUNCHES, blur_solve.LAUNCHES, flow_iter.LAUNCHES) == \
        (counts[0], counts[1], counts[2] + 1)
    assert torch.allclose(out, ref, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("b,h,w", [(1, 16, 16), (3, 37, 53), (2, 17, 300),
                                   (12, 320, 320), (12, 40, 40),
                                   (48, 40, 40), (40, 100, 150)])
@pytest.mark.parametrize("scale", [0.0, 3.0, 40.0])
def test_flow_iter_kernel_keeps_the_plain_order_of_sums(gen, b, h, w, scale):
    """The warp, update, sums and solve round as in the plain version
    (blur.cuh's order, no contraction): the kernel equals it bit for bit on
    both tiles ((12, 320, 320) and (40, 100, 150) take the 32×80 one, the
    others the 32×8 one), on ragged edges and on a large pan that
    leaves most pixels out of bounds."""
    R0 = torch.randn((b, 5, h, w), generator=gen, device="cuda")
    R1 = torch.randn((b, 5, h, w), generator=gen, device="cuda")
    fl = (torch.rand((b, 2, h, w), generator=gen, device="cuda") - 0.5) \
        * scale
    assert torch.equal(flow_iter.solve_iteration(R0, R1, fl),
                       flow_iter.solve_iteration_plain(R0, R1, fl))


@pytest.mark.parametrize("b,h,w", [(3, 37, 53), (12, 320, 320)])
def test_flow_iter_kernel_never_adds_the_unwritten_staged_columns(gen, b, h,
                                                                  w):
    """Staged columns 0 and 47 of blur.cuh's tile are read into the
    register windows, but the fused round never writes them and must never
    add them.  Shared memory keeps what earlier blocks left in it, so two
    launches first fill it with NaN: blur+solve on an all-NaN M over many
    blocks (its tile has the same 52-word pitch and stages every column),
    then the fused round on all-NaN fields at this shape (its row sums
    fill columns 0 … 31).  A kernel that added either column would give
    NaN.  The first shape takes the 32×8 tile, the second the 32×80 one."""
    R0 = torch.randn((b, 5, h, w), generator=gen, device="cuda")
    R1 = torch.randn((b, 5, h, w), generator=gen, device="cuda")
    fl = (torch.rand((b, 2, h, w), generator=gen, device="cuda") - 0.5) * 3
    ref = flow_iter.solve_iteration_plain(R0, R1, fl)
    nan = float("nan")
    blur_solve.box_blur_solve(torch.full((48, 5, 320, 320), nan,
                                         device="cuda"))
    r_nan = torch.full_like(R0, nan)
    flow_iter.solve_iteration(r_nan, r_nan, torch.zeros_like(fl))
    out = flow_iter.solve_iteration(R0, R1, fl)
    assert torch.isfinite(out).all()
    assert torch.equal(out, ref)


def test_flow_iter_wrapper_refuses_what_the_kernel_does_not_take(gen):
    R = torch.randn((1, 5, 32, 32), generator=gen, device="cuda")
    fl = torch.zeros((1, 2, 32, 32), device="cuda")
    with pytest.raises(ValueError, match="H, W >= 16"):
        flow_iter.solve_iteration(R[..., :8], R[..., :8], fl[..., :8])
    with pytest.raises(ValueError, match="winsize"):
        flow_iter.solve_iteration(R, R, fl, winsize=9)
    with pytest.raises(TypeError):
        flow_iter.solve_iteration(R.double(), R, fl)
    with pytest.raises(ValueError):
        flow_iter.solve_iteration(R, R, fl[:, :1])


def _qkv(gen, shape):
    return [torch.randn(shape, generator=gen, device="cuda").bfloat16()
            for _ in range(3)]


def _assert_matches_plain(out, ref, t):
    """Within 2e-2 of the plain version; the tiled kernel (T past the
    register-row kernel's instances) also within ``TILED_ULPS`` bf16 ulps
    at the larger of each output's magnitude and its row's RMS, a measure
    that a lost key chunk or an unmasked padded key fails
    (``chip_smoke._wrong_answers_show``)."""
    assert torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    if t > attention.MMA_MAX_TOKENS:
        worst, _ = _ulps_off(out, ref, out.shape[-1])
        assert worst <= TILED_ULPS, worst


# token counts at the edges of the 16-key tiles and of the three instances
# (T <= 32, 80, 208), head dims at the edges of theirs (16, 64, 128), and
# shapes past the largest instance, which take the tiled kernel: the edges
# of its 64-key tiles and 16-key chunks, both of its instances (D <= 64,
# 128), the TimeSformer's spatial attention (785 tokens, 12 heads) and a
# length no shared memory could hold whole
_MHA_SHAPES = [(2, 3, t, d) for t in (16, 17, 32, 33, 65, 197, 208)
               for d in (64, 8, 128)] + \
    [(8, 4, 17, 64), (3, 6, 197, 64), (2, 1, 1, 16), (1, 2, 80, 24),
     (1, 2, 81, 40), (2, 2, 100, 72), (1, 5, 300, 40), (1, 2, 209, 64),
     (2, 2, 81, 64), (1, 3, 128, 64), (5, 2, 193, 64), (40, 6, 197, 64)] + \
    [(2, 3, t, d) for t in (209, 255, 256, 257, 272, 785) for d in (64, 8,
                                                                     128)] + \
    [(2, 12, 785, 64), (1, 2, 1000, 40), (1, 1, 4000, 64)]


@pytest.mark.parametrize("b,h,t,d", _MHA_SHAPES)
def test_mha_kernel_matches_plain(gen, b, h, t, d):
    q, k, v = _qkv(gen, (b, h, t, d))
    before = attention.LAUNCHES
    by_variant = dict(attention.VARIANT_LAUNCHES)
    out = attention.mha(q, k, v)
    assert attention.LAUNCHES == before + 1
    which = "mma" if t <= attention.MMA_MAX_TOKENS else "tiled"
    assert attention.variant(t, d) == which
    by_variant[which] += 1
    assert attention.VARIANT_LAUNCHES == by_variant
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = attention.mha_plain(q, k, v)
    assert attention.LAUNCHES == before + 1
    _assert_matches_plain(out, ref, t)


@pytest.mark.parametrize("b,h,t,d", [(4, 3, 197, 64), (2, 3, 17, 8),
                                     (2, 2, 65, 128), (2, 3, 785, 64),
                                     (1, 2, 300, 128)])
def test_mha_kernel_matches_plain_on_large_scores(gen, b, h, t, d):
    """q and k scaled by 8: scaled scores of magnitude 8·√D·… with rows that
    are nearly one-hot.  Both kernels fold the scale into a base-2
    exponent, 2^((s − max)·scale·log2 e); here that exponent reaches into
    the hundreds, where its rounding differs most from scaling first, and
    the tiled kernel's running max grows by as much from tile to tile."""
    q, k, v = _qkv(gen, (b, h, t, d))
    q, k = q * 8, k * 8
    assert attention.variant(t, d) == (
        "mma" if t <= attention.MMA_MAX_TOKENS else "tiled")
    out = attention.mha(q, k, v)
    ref = attention.mha_plain(q, k, v)
    assert torch.isfinite(out.float()).all()
    _assert_matches_plain(out, ref, t)


@pytest.mark.parametrize("t", [21, 233])
def test_mha_kernel_ignores_what_lies_past_t(gen, t):
    """Rows and key columns from T up to the padded tile are zero-filled in
    shared memory, never read: NaNs behind each head's rows change
    nothing (both kernels)."""
    b, h, d = 2, 3, 64
    buf = torch.full((b, h, 3, t + 11, d), float("nan"), device="cuda",
                     dtype=torch.bfloat16)
    buf[:, :, :, :t] = torch.randn((b, h, 3, t, d), generator=gen,
                                   device="cuda").bfloat16()
    q, k, v = (buf[:, :, i, :t] for i in range(3))
    out = attention.mha(q, k, v)
    ref = attention.mha_plain(q, k, v)
    assert torch.isfinite(out.float()).all()
    _assert_matches_plain(out, ref, t)


@pytest.mark.parametrize("b,t,h,d", [(2, 17, 3, 8), (4, 197, 6, 64)])
def test_attention_reads_the_qkv_views_in_place(gen, b, t, h, d):
    qkv = torch.randn((b, t, 3, h, d), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = attention.LAUNCHES
    out = attention.attention(q, k, v)
    assert attention.LAUNCHES == before + 1
    assert out.shape == (b, t, h * d) and out.is_contiguous()
    ref = attention.attention_plain(q, k, v)
    assert torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_attention_wrapper_refuses_what_the_kernel_does_not_take(gen):
    q, k, v = _qkv(gen, (1, 2, 9, 16))
    with pytest.raises(TypeError):
        attention.mha(q.float(), k, v)
    with pytest.raises(ValueError, match="multiple of 8"):
        attention.mha(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match="shapes"):
        attention.mha(q, k[:, :1], v)
    # each entry point refuses a length outside its range, never reroutes
    fns = attention._lib()
    for which, t in (("mma", attention.MMA_MAX_TOKENS + 1),
                     ("tiled", attention.MMA_MAX_TOKENS)):
        x = torch.zeros((1, t, 1, 64), dtype=torch.bfloat16, device="cuda")
        st = [(ctypes.c_int64 * 3)(*x.stride()[:3]) for _ in range(4)]
        err = fns[which](*[x.data_ptr()] * 4, 1, 1, t, 64, *st, 0.125,
                         torch.cuda.current_stream().cuda_stream)
        assert err != 0, (which, t)


# ---------------------------------------------------------------------------
# the detector families of the serving path
# ---------------------------------------------------------------------------

def test_mha_kernel_at_the_moe_small_shape(gen):
    """``moe_small`` with AVD_ATTN_FUSED=1 attends at [B,4,17,64]: a
    256-frame bucket, through the block's strided qkv views and the
    head-major entry point."""
    b, t, h, d = 256, 17, 4, 64
    qkv = torch.randn((b, t, 3, h, d), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert attention.variant(t, d) == "mma"
    before = attention.LAUNCHES
    out = attention.attention(q, k, v)
    assert attention.LAUNCHES == before + 1
    ref = attention.attention_plain(q, k, v)
    assert torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = attention.mha(qh, kh, vh)
    assert torch.allclose(out.float(), attention.mha_plain(qh, kh, vh).float(),
                          atol=2e-2, rtol=2e-2)


def _qdense_calls(fam, preset, n_frames):
    """Every (x, quantized weight, bias) that the int8 forward of ``fam`` at
    ``preset`` hands ``qdense`` on the card, with the seeded weights."""
    from avd_tpu_torch.models import quant
    cfg = fam.make_config(preset)
    qp = quant.to_device(quant.quantize_params(fam.init_params(0, cfg)),
                         "cuda")
    frames = torch.rand((n_frames, cfg.image_size, cfg.image_size, 3),
                        device="cuda")
    calls = []
    real = quant.qdense

    def spy(x, qw, b=None):
        calls.append((x.clone(), qw, b))
        return real(x, qw, b)

    quant.qdense = spy
    try:
        quant.forward(qp, frames, cfg)
    finally:
        quant.qdense = real
    return calls


@pytest.mark.parametrize("arch,preset,n_frames", [
    ("vit", "full", 2), ("vit", "full", 1), ("cnn", "small", 3),
    ("cnn", "small", 1), ("vit", "small", 1)])
def test_int_mm_qdense_equals_the_cpu_int32_path(gen, arch, preset,
                                                 n_frames):
    """Every qdense shape of the ViT and CNN int8 forwards: torch._int_mm
    on the card (rows padded to 17 where fewer) gives the CPU's exact
    int32 product on the same int8 operands, and qdense's dequantized
    output bit for bit (every division is a true one on both)."""
    from avd_tpu_torch import models
    from avd_tpu_torch.models import quant
    calls = _qdense_calls(models.family(arch), preset, n_frames)
    assert calls
    shapes = set()
    for x, qw, b in calls:
        x_cpu = x.cpu()
        qw_cpu = {k: v.cpu() for k, v in qw.items()}
        x2 = x_cpu.reshape(-1, x.shape[-1])
        x_i8 = torch.round(x2 / quant._scale(x2.abs().amax(
            dim=-1, keepdim=True))).to(torch.int8)
        assert torch.equal(
            quant.int_matmul(x_i8.cuda(), qw["w_i8"]).cpu(),
            quant.int_matmul(x_i8, qw_cpu["w_i8"])), tuple(x.shape)
        got = quant.qdense(x, qw, b)
        want = quant.qdense(x_cpu, qw_cpu, None if b is None else b.cpu())
        assert torch.equal(got.cpu(), want), tuple(x.shape)
        shapes.add((x.reshape(-1, x.shape[-1]).shape[0],)
                   + tuple(qw["w_i8"].shape))
    if (arch, n_frames) == ("cnn", 1):
        assert any(m <= 16 for m, _, _ in shapes), shapes  # padded rows


@pytest.mark.parametrize("m", [1, 16, 17, 33, 394])
def test_int_matmul_is_exact_at_every_row_count(gen, m):
    from avd_tpu_torch.models import quant
    x = torch.randint(-127, 128, (m, 64), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (64, 24), generator=gen, device="cuda",
                      dtype=torch.int8)
    got = quant.int_matmul(x, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, 24)
    assert torch.equal(got.cpu(), x.cpu().int() @ w.cpu().int())
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int_matmul(x[:, :60].contiguous(), w[:60])


# ---------------------------------------------------------------------------
# training and exported programs on the card (no kernel of their own: the
# plain path in cuBLAS and PyTorch's kernels)
# ---------------------------------------------------------------------------

_TRAIN_FAMILIES = {
    "vit": ("vit", "small", dict(image_size=32, width=64, depth=2, heads=2),
            (8, 32, 32, 3), (8,)),
    "moe": ("vit", "small", dict(image_size=32, width=64, depth=2, heads=2,
                                 n_experts=4), (8, 32, 32, 3), (8,)),
    "cnn": ("cnn", "small", dict(image_size=32), (8, 32, 32, 3), (8,)),
    "temporal": ("temporal", "small", dict(image_size=32, width=64, depth=1,
                                           frame_depth=1, heads=2),
                 (2, 4, 32, 32, 3), (2, 4)),
}


def _loss_and_grads(family, cfg, params, x, y):
    from avd_tpu_torch.models import optim
    leaves = optim.leaves_of(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = family.loss_fn(params, x, y, cfg, logit_l2=0.02)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return float(loss.detach()), [g.float().cpu() for g in grads]


@pytest.mark.parametrize("name", sorted(_TRAIN_FAMILIES))
def test_train_step_on_the_card(gen, name):
    """The loss of each family on the card within 1e-4 of the CPU's at the
    same weights and batch, each leaf's gradient within relative L2 3e-2
    of the CPU's (the bound the CPU is held to against JAX), remat
    gradients equal to the plain ones; one AdamW step leaves finite
    parameters that moved."""
    import dataclasses

    from avd_tpu_torch import models
    from avd_tpu_torch.models import optim
    from avd_tpu_torch.models.detector import _map_tree
    arch, preset, over, xs, ys = _TRAIN_FAMILIES[name]
    family = models.family(arch)
    cfg = family.make_config(preset, **over)
    cpu = family.init_params(0, cfg)
    x = torch.rand(xs, generator=gen, device="cuda")
    y = (torch.rand(ys, generator=gen, device="cuda") > 0.5).int()

    def on_card():
        return _map_tree(lambda _, v: v.cuda().clone(), cpu)

    ref_loss, ref_grads = _loss_and_grads(
        family, cfg, _map_tree(lambda _, v: v.clone(), cpu), x.cpu(),
        y.cpu())
    loss, grads = _loss_and_grads(family, cfg, on_card(), x, y)
    assert abs(loss - ref_loss) <= 1e-4, (loss, ref_loss)
    for i, (a, b) in enumerate(zip(grads, ref_grads)):
        assert torch.isfinite(a).all(), i
        err = float(torch.linalg.norm(a - b))
        assert err <= 3e-2 * float(torch.linalg.norm(b)) + 1e-12, (i, err)
    if arch == "vit":
        _, remat = _loss_and_grads(family, dataclasses.replace(cfg,
                                                               remat=True),
                                   on_card(), x, y)
        for a, b in zip(grads, remat):
            assert torch.equal(a, b)
    opt = family.make_optimizer(1e-3)
    step = family.make_train_step(cfg, opt, logit_l2=0.02)
    params = on_card()
    params, state, loss = step(params, opt.init(optim.leaves_of(params)),
                               x, y)
    assert state["count"] == 1 and torch.isfinite(loss)
    moved = max(float((a.detach().cpu() - b).abs().max()) for a, b in zip(
        optim.leaves_of(params), optim.leaves_of(cpu)))
    assert 1e-4 < moved < 2e-3


@pytest.mark.parametrize("arch,over,traced_on", [
    ("vit", dict(image_size=32, width=64, depth=2, heads=2), "cuda"),
    ("vit", dict(image_size=32, width=64, depth=2, heads=2), "cpu"),
    ("temporal", dict(image_size=32, width=64, depth=1, frame_depth=1,
                      heads=2), "cuda")])
def test_exported_program_matches_eager_on_the_card(gen, tmp_path, arch,
                                                    over, traced_on):
    """A program traced on the card (or on the CPU and moved there) against
    the eager bundle on the card: within 1e-3."""
    from avd_tpu_torch.models import export
    out = str(tmp_path / "artifact")
    export.export_detector(out, arch=arch, preset="small", ckpt=None,
                           batch=4, window=4, config_overrides=over,
                           device=traced_on)
    _, _, probs, source = export.load_bundle(out, "cuda")
    assert source == "exported:random_init"
    fam, cfg, _, params, _, _ = export._build(arch, "small", None, over)
    params = fam.cast_for_inference(params, "cuda")
    x = torch.rand((4, 32, 32, 3), generator=gen, device="cuda")
    with torch.inference_mode():
        if arch == "temporal":
            got = probs(x, 3)
            mask = torch.arange(4, device="cuda") < 3
            want = torch.sigmoid(fam.forward_clip(params, x, cfg,
                                                  mask=mask)[:, 0].float())
        else:
            got = probs(x)
            want = torch.sigmoid(fam.forward(params, x, cfg)[:, 0].float())
    assert got.device.type == "cuda"
    assert float((got - want).abs().max()) <= 1e-3
