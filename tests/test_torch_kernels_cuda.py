"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present.  Run
them on a GPU machine (which needs no jax) with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The shapes here are the awkward ones (widths off the 32-pixel tile, tiny
planes, a batch of one, token counts at the edges of the 16-key tiles);
``chip_smoke.py`` covers the main path's shapes.
"""

import pytest
import torch

from avd_tpu_torch.ops import flow as flow_ops
from avd_tpu_torch.ops.kernels import attention, blur_solve, flow_iter, warp

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


@pytest.mark.parametrize("b,h,w", _BLUR_SHAPES + [(3, 41, 67), (2, 24, 40)])
def test_blur_solve_kernel_bf16_equals_plain(gen, b, h, w):
    """bf16 M, staged through registers and widened: the same sums in the
    same order as the plain version on the widened field, bit for bit, on
    both tiles, aligned (W % 8 == 0) and not."""
    m = _psd_m(gen, b, h, w)
    before = dict(blur_solve.DTYPE_LAUNCHES)
    out = blur_solve.box_blur_solve(m.bfloat16())
    assert blur_solve.DTYPE_LAUNCHES == {**before,
                                         "bfloat16": before["bfloat16"] + 1}
    assert out.dtype == torch.float32
    assert torch.equal(out, blur_solve.box_blur_solve_plain(m.bfloat16()))


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


# token counts at the edges of the 16-key tiles and of the three instances
# (T <= 32, 80, 208), head dims at the edges of theirs (16, 64, 128), and
# shapes past the largest instance, which take the general kernel
_MHA_SHAPES = [(2, 3, t, d) for t in (16, 17, 32, 33, 65, 197, 208)
               for d in (64, 8, 128)] + \
    [(8, 4, 17, 64), (3, 6, 197, 64), (2, 1, 1, 16), (1, 2, 80, 24),
     (1, 2, 81, 40), (2, 2, 100, 72), (1, 5, 300, 40), (1, 2, 209, 64),
     (2, 2, 81, 64), (1, 3, 128, 64), (5, 2, 193, 64), (40, 6, 197, 64)]


@pytest.mark.parametrize("b,h,t,d", _MHA_SHAPES)
def test_mha_kernel_matches_plain(gen, b, h, t, d):
    q, k, v = _qkv(gen, (b, h, t, d))
    before = attention.LAUNCHES
    by_variant = dict(attention.VARIANT_LAUNCHES)
    out = attention.mha(q, k, v)
    assert attention.LAUNCHES == before + 1
    which = "mma" if t <= attention.MMA_MAX_TOKENS else "general"
    assert attention.variant(t, d) == which
    by_variant[which] += 1
    assert attention.VARIANT_LAUNCHES == by_variant
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = attention.mha_plain(q, k, v)
    assert attention.LAUNCHES == before + 1
    assert torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("b,h,t,d", [(4, 3, 197, 64), (2, 3, 17, 8),
                                     (2, 2, 65, 128)])
def test_mha_kernel_matches_plain_on_large_scores(gen, b, h, t, d):
    """q and k scaled by 8: scaled scores of magnitude 8·√D·… with rows that
    are nearly one-hot.  The tensor-core kernel folds the scale into a base-2
    exponent, 2^((s − max)·scale·log2 e); here that exponent reaches into
    the hundreds, where its rounding differs most from scaling first."""
    q, k, v = _qkv(gen, (b, h, t, d))
    q, k = q * 8, k * 8
    assert attention.variant(t, d) == "mma"
    out = attention.mha(q, k, v)
    ref = attention.mha_plain(q, k, v)
    assert torch.isfinite(out.float()).all()
    assert torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_mha_kernel_ignores_what_lies_past_t(gen):
    """Rows and key columns from T up to the padded tile are zero-filled in
    shared memory, never read: NaNs behind each head's rows change
    nothing."""
    b, h, t, d = 2, 3, 21, 64
    buf = torch.full((b, h, 3, t + 11, d), float("nan"), device="cuda",
                     dtype=torch.bfloat16)
    buf[:, :, :, :t] = torch.randn((b, h, 3, t, d), generator=gen,
                                   device="cuda").bfloat16()
    q, k, v = (buf[:, :, i, :t] for i in range(3))
    out = attention.mha(q, k, v)
    ref = attention.mha_plain(q, k, v)
    assert torch.isfinite(out.float()).all()
    assert torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


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
    big = _qkv(gen, (1, 1, 4000, 64))
    with pytest.raises(ValueError, match="shared memory"):
        attention.mha(*big)


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
