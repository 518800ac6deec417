"""The TimeSformer family of the port (CPU): the forward against its plain
reference, its route through the attention kernel, the ViT's einsum
attention core, the window contract of ``models/scoring.py``, the modes
that refuse it, the streaming path, and its spans.

There is no JAX counterpart: the family is the port's own, held to
``oracle/timesformer_ref.py`` (plain float32 torch, every bf16 rounding of
the program emulated with ``dtype=torch.bfloat16``) and that to the
benchmark's copy, ``benchmark/reference/timesformer.py``.
"""

import inspect

import numpy as np
import pytest
import torch

from avd_tpu_torch import models
from avd_tpu_torch.analyzers import video as video_an
from avd_tpu_torch.models import convert, detector, export, scoring
from avd_tpu_torch.models import timesformer as tsf
from avd_tpu_torch.oracle import timesformer_ref as oracle
from avd_tpu_torch.ops.kernels import attention as attention_k
from avd_tpu_torch.utils.metrics import SPANS
from benchmark.reference import timesformer as bench_ref

torch.set_num_threads(2)

_DET_ENV = ("AVD_DETECTOR", "AVD_DETECTOR_BLEND", "AVD_DETECTOR_ARCH",
            "AVD_DETECTOR_PRESET", "AVD_DETECTOR_CKPT", "AVD_DETECTOR_TEMP",
            "AVD_DETECTOR_QUANT", "AVD_DETECTOR_EXPORTED", "AVD_ATTN_FUSED",
            "AVD_TEMPORAL_WINDOW", "AVD_DETECTOR_SLAB")
CFG = tsf.make_config("tiny")
# The forward against the reference at the same roundings: the reference
# rounds each product's result once after its bias (the program rounds
# the product, then the sum with the bias), so a few elements differ by a
# bf16 ulp, which reads up to 6e-3 on a logit of these weights
# (0.57-1.18 spread); 0.02 leaves three times that, and every planted
# fault below moves the logits by 0.65 or more.
TOL = 0.02
# Weights 10 × the published initializer_range: at N(0, 0.02²) the tiny
# config's logits barely depend on the temporal branch (dropping it moves
# them by 1e-3), so the faults could not show.
SCALE = 10.0


@pytest.fixture
def env(monkeypatch):
    for name in _DET_ENV:
        monkeypatch.delenv(name, raising=False)
    scoring._bundle.cache_clear()
    yield monkeypatch
    scoring._bundle.cache_clear()


def _params(seed: int):
    p = tsf.init_params(seed, CFG)
    return detector._map_tree(
        lambda n, x: x * SCALE if n.endswith(("_w", "_tok", "_emb"))
        else x, p)


def _clips(seed: int, w: int = 3) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).random(
        (w, CFG.frames, CFG.image_size, CFG.image_size, 3), np.float32))


def _program(params, clips, namespace=None):
    ns = namespace or {}
    saved = {k: getattr(tsf, k) for k in ns}
    try:
        for k, v in ns.items():
            setattr(tsf, k, v)
        return tsf.forward(tsf.cast_for_inference(params, "cpu"), clips,
                           CFG)[:, 0]
    finally:
        for k, v in saved.items():
            setattr(tsf, k, v)


def _mutated(fn: str, old: str, new: str):
    """``tsf.<fn>`` with one line of its source replaced."""
    src = inspect.getsource(getattr(tsf, fn))
    assert old in src
    ns = dict(vars(tsf))
    exec(src.replace(old, new), ns)
    return {fn: ns[fn]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_the_reference_in_bf16(seed):
    p, x = _params(seed), _clips(seed)
    z = _program(p, x)
    zr = oracle.forward(p, x, CFG.heads, CFG.patch, dtype=torch.bfloat16)
    assert z.shape == (3,)
    assert float((z - zr).abs().max()) <= TOL
    # the windows differ, and float32 lies near
    assert float(zr.std()) > 0.1
    z32 = oracle.forward(p, x, CFG.heads, CFG.patch)
    assert float((z - z32).abs().max()) <= 0.1


def _no_temporal(p):
    return dict(p, layers=[dict(lp, temporal_dense_w=0 * lp[
        "temporal_dense_w"], temporal_dense_b=0 * lp["temporal_dense_b"])
        for lp in p["layers"]])


@pytest.mark.parametrize("fault", ["temporal-dropped", "cls-from-frame-0",
                                   "t-n-order"])
def test_planted_faults_exceed_the_tolerance_three_times(fault):
    p, x = _params(0), _clips(0)
    zr = oracle.forward(p, x, CFG.heads, CFG.patch, dtype=torch.bfloat16)
    if fault == "temporal-dropped":
        z = _program(_no_temporal(p), x)
    elif fault == "cls-from-frame-0":
        z = _program(p, x, _mutated(
            "block_forward", "bs[:, :, 0].float().mean(dim=1)",
            "bs[:, 0, 0].float()"))
    else:  # the stream laid out frame-major, read patch-major
        z = _program(p, x, _mutated(
            "embed", 'x = x.transpose(1, 2) + _bf16(params["time_emb"])',
            'x = x + _bf16(params["time_emb"])[:, None]'))
    assert float((z - zr).abs().max()) >= 3 * TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_two_references_agree(tmp_path, dtype):
    """The benchmark's copy, reading a checkpoint it wrote itself, gives
    the oracle's logits on the port's tree of the same file."""
    sizes = dict(image_size=CFG.image_size, patch=CFG.patch,
                 frames=CFG.frames, width=CFG.width, mlp=CFG.mlp_width,
                 depth=CFG.depth)
    bench_ref.write_seeded(str(tmp_path), np.random.default_rng(5), **sizes)
    p_bench = bench_ref.load(str(tmp_path), "cpu")
    p_port = convert.load_checkpoint(str(tmp_path), CFG)
    x = _clips(5)
    zb = bench_ref.forward(p_bench, x, CFG.heads, CFG.patch, dtype)
    zo = oracle.forward(p_port, x, CFG.heads, CFG.patch, dtype)
    assert torch.equal(zb, zo)
    u8 = (x.numpy()[..., ::-1] * 255).round().astype(np.uint8)
    logits = bench_ref.window_logits(p_bench, list(u8), CFG.heads, CFG.patch,
                                     "cpu", block=2, dtype=dtype)
    rgb = torch.from_numpy(np.ascontiguousarray(u8[..., ::-1])).float() / 255
    # blocks of 2 against one forward of 3: the products' sums may group
    # differently, so f32 round-off apart
    np.testing.assert_allclose(logits, bench_ref.forward(
        p_bench, rgb, CFG.heads, CFG.patch, dtype).double().numpy(),
        atol=1e-5)


def _old_block_forward_aux(x, lp, cfg, router_x=None):
    """``detector.block_forward_aux`` (dense, einsum attention) as it was
    before the attention core became a function of its own."""
    b_ = detector._bf16
    h = b_(detector._ln(x.float(), lp["ln1_scale"], lp["ln1_bias"]))
    qkv = h @ b_(lp["qkv_w"]) + b_(lp["qkv_b"])
    b, t, _ = qkv.shape
    qkv = qkv.reshape(b, t, 3, cfg.heads, cfg.head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    att = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    att = torch.softmax(att / np.sqrt(cfg.head_dim), dim=-1)
    o = torch.einsum("bhts,bshd->bthd", b_(att).float(), v.float())
    o = b_(o.reshape(b, t, cfg.width))
    x = x + (o @ b_(lp["proj_w"]) + b_(lp["proj_b"]))
    h = b_(detector._ln(x.float(), lp["ln2_scale"], lp["ln2_bias"]))
    h = h @ b_(lp["mlp_in_w"]) + b_(lp["mlp_in_b"])
    h = torch.nn.functional.gelu(h, approximate="tanh")
    return x + (h @ b_(lp["mlp_out_w"]) + b_(lp["mlp_out_b"])), 0.0


@pytest.mark.parametrize("preset", ["small", "full"])
def test_vit_forward_is_bit_equal_through_the_shared_core(preset,
                                                          monkeypatch):
    cfg = detector.make_config(preset, depth=2)
    p = detector.cast_for_inference(detector.init_params(3, cfg), "cpu")
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, cfg.image_size, cfg.image_size, 3), np.float32))
    new = detector.forward(p, x, cfg)
    monkeypatch.setattr(detector, "block_forward_aux",
                        _old_block_forward_aux)
    assert torch.equal(new, detector.forward(p, x, cfg))


def test_each_block_attends_through_the_kernel_twice(monkeypatch):
    """Each block's temporal (T frames a patch) and spatial (N + 1 tokens a
    frame) attentions go through ``ops/kernels/attention.attention``, in
    that order, and the einsum core is not called; at ``hr`` the spatial
    one takes the ``"tiled"`` kernel and the temporal one ``"mma"``."""
    calls = []
    real = attention_k.attention

    def spy(q, k, v):
        calls.append(tuple(q.shape))
        return real(q, k, v)

    def core(q, k, v):
        raise AssertionError("detector.attention_core was called")

    monkeypatch.setattr(attention_k, "attention", spy)
    monkeypatch.setattr(detector, "attention_core", core)
    w, n, t = 2, CFG.patches, CFG.frames
    z = _program(_params(0), _clips(0, w))
    assert z.shape == (w,) and bool(torch.isfinite(z).all())
    h, d = CFG.heads, CFG.head_dim
    assert calls == [(w * n, t, h, d), (w * t, n + 1, h, d)] * CFG.depth
    hr = tsf.make_config("hr")
    assert attention_k.variant(hr.patches + 1, hr.head_dim) == "tiled"
    assert attention_k.variant(hr.frames, hr.head_dim) == "mma"


class _Recorder:
    """A probs function with the window contract's attributes: each
    window's probability is its first frame's first pixel / 255."""

    def __init__(self, t: int, most: int):
        self.clip_window, self.max_windows, self.sizes = t, most, []

    def __call__(self, windows: torch.Tensor) -> torch.Tensor:
        self.sizes.append(windows.shape[0])
        return windows[:, 0, 0, 0, 0].float() / 255.0


@pytest.mark.parametrize("n", [16, 17, 31, 32, 40, 5])
def test_window_contract(n):
    rec = _Recorder(16, 2)
    frames = np.zeros((n, 2, 2, 3), np.uint8)
    frames[:, 0, 0, 0] = np.arange(n)              # frame i reads i / 255
    out = scoring._score_windows(frames, rec, "w")
    tl = np.asarray(out["timeline"]) * 255.0
    assert len(tl) == n and out["weights"] == "w"
    starts = scoring.window_starts(max(n, 16), 16)
    assert all(s + 16 <= max(n, 16) for s in starts)   # none padded
    if n >= 16:
        assert starts[-1] == n - 16
    # each frame takes the first window that holds it
    first = [min(s for s in starts if s <= i < s + 16) for i in range(n)]
    if n < 16:  # padded with the last frame to one window
        assert starts == [0]
    np.testing.assert_allclose(tl, first, atol=1e-4)
    k = len(starts)
    assert sum(rec.sizes) == k and all(
        m in (1, 2) for m in rec.sizes) and rec.sizes == sorted(
            rec.sizes, reverse=True)


def test_forward_sizes_are_powers_of_two_up_to_the_most():
    assert scoring.forward_sizes(12, 4) == [4, 4, 4]
    assert scoring.forward_sizes(7, 8) == [4, 2, 1]
    assert scoring.forward_sizes(12, 8) == [8, 4]
    assert scoring.forward_sizes(0, 8) == []


def _serve(env, ckpt=None, **extra):
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_ARCH", "timesformer")
    env.setenv("AVD_DETECTOR_PRESET", "tiny")
    if ckpt:
        env.setenv("AVD_DETECTOR_CKPT", ckpt)
    for k, v in extra.items():
        env.setenv(k, v)
    scoring._bundle.cache_clear()


def test_served_timeline_is_the_references_windows(env, tmp_path):
    """``detector_timeline`` through the normal path on a checkpoint:
    each frame's probability is that of its first window by the
    reference, and ``weights`` names the checkpoint."""
    bench_ref.write_seeded(str(tmp_path), np.random.default_rng(7),
                           image_size=CFG.image_size, patch=CFG.patch,
                           frames=CFG.frames, width=CFG.width,
                           mlp=CFG.mlp_width, depth=CFG.depth)
    _serve(env, str(tmp_path))
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (10, 48, 40, 3), dtype=np.uint8)
    det = scoring.detector_timeline(frames, device="cpu")
    assert det["weights"] == str(tmp_path) and len(det["timeline"]) == 10
    resized = scoring.resize_frames(frames, CFG.image_size)
    starts = scoring.window_starts(10, 4)
    assert starts == [0, 4, 6]
    params = bench_ref.load(str(tmp_path), "cpu")
    z = bench_ref.window_logits(params, [resized[s:s + 4] for s in starts],
                                CFG.heads, CFG.patch, "cpu",
                                dtype=torch.bfloat16)
    p = np.asarray(det["timeline"])
    want = 1 / (1 + np.exp(-z[[0, 0, 0, 0, 1, 1, 1, 1, 2, 2]]))
    np.testing.assert_allclose(p, want, atol=TOL / 4)


def test_streaming_slabs_give_the_batch_timeline(env):
    _serve(env, AVD_DETECTOR_SLAB="8")
    frames = np.random.default_rng(2).integers(0, 256, (14, 40, 40, 3),
                                               dtype=np.uint8)
    batch = scoring.detector_timeline(frames, device="cpu")["timeline"]
    acc = video_an._DetAccum("cpu")
    for s in range(0, 14, 3):
        acc.add(frames[s:s + 3])
    got = acc.result()
    assert acc.error is None and len(got["timeline"]) == 14
    np.testing.assert_allclose(got["timeline"], batch, atol=1e-6)


@pytest.mark.parametrize("mode", ["AVD_ATTN_FUSED", "AVD_DETECTOR_QUANT"])
def test_modes_that_do_not_apply_raise_naming_the_family(env, mode):
    _serve(env, **{mode: "1"})
    with pytest.raises(ValueError, match="timesformer"):
        scoring.input_size("cpu")


def test_export_raises_naming_the_family(tmp_path):
    with pytest.raises(ValueError, match="timesformer"):
        export.export_detector(str(tmp_path), arch="timesformer",
                               preset="tiny", ckpt=None, device="cpu")


def _count(shapes) -> int:
    if isinstance(shapes, dict):
        return sum(_count(v) for v in shapes.values())
    if isinstance(shapes, list):
        return sum(_count(v) for v in shapes)
    return int(np.prod(shapes))


def test_family_api_and_rank_group_rule(env):
    assert "timesformer" in models.FAMILIES
    assert models.family("timesformer") is tsf
    assert scoring._default_preset("timesformer") == "hr"
    hr = tsf.make_config("hr")
    n = _count(tsf.param_shapes(hr))
    assert 121_000_000 < n < 122_000_000
    assert (hr.image_size, hr.patch, hr.frames, hr.width, hr.depth,
            hr.heads, hr.mlp_width) == (448, 16, 16, 768, 12, 12, 3072)
    _serve(env)
    assert not scoring.sharded()       # one rank alone in a group
    assert scoring.clip_window("cpu") == 4 and scoring.window_overlap("cpu")


def test_spans_carry_windows_and_bucket(env):
    _serve(env)
    before = SPANS.flat()
    scoring.score_resized(np.zeros((9, 32, 32, 3), np.uint8), device="cpu")
    after = SPANS.flat()

    def added(key):
        return after.get(key, 0) - before.get(key, 0)

    assert added("span_det_forward_windows_total") == 3   # [2, 1]
    assert added("span_det_stage_bucket_total") == 12
    assert added("span_det_stage_frames_total") == 9


def test_warm_scores_every_forward_size(env):
    """Black clips of 1 and 2 windows at ``tiny`` (``max_windows`` 2):
    one forward of each size."""
    _serve(env)
    before = SPANS.flat()
    scoring.warm("cpu")
    after = SPANS.flat()
    assert after["span_det_forward_count"] - before.get(
        "span_det_forward_count", 0) == 2
    assert after["span_det_forward_windows_total"] - before.get(
        "span_det_forward_windows_total", 0) == 3
