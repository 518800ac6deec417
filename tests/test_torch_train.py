"""The port's training driver on the CPU: the single-device contract of
``tests/test_train.py`` (learning, checkpoints, resume, schedules,
accumulation, clipping, EMA, the curriculum, codec augmentation, the
resolution transfer) held on ``avd_tpu_torch.models.train``.

Every run is small (16-32 px, one or two layers, pools of a few dozen
samples) and asks for the CPU; the card runs the full-width recipe in
``chip_smoke.py`` phase 27.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from avd_tpu_torch.models import cnn, convert, optim
from avd_tpu_torch.models import detector
from avd_tpu_torch.models import temporal
from avd_tpu_torch.models import train

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(batch=8, lr=1e-3, image_size=16, width=32, depth=1, heads=2,
            log_every=0, cache_samples=64, families=("blobs",),
            device="cpu")


def _leaves(tree):
    return [x.detach() for x in optim.leaves_of(tree)]


def _equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_synthetic_batch_shapes():
    frames, labels = train.synthetic_batch(np.random.default_rng(0), 8, 32)
    assert frames.shape == (8, 32, 32, 3) and frames.dtype == np.float32
    assert set(np.unique(labels)) <= {0, 1}
    assert 0.0 <= frames.min() and frames.max() <= 1.0


def test_training_learns_synthetic_task():
    _, losses = train.train(steps=60, batch=16, lr=1e-3, image_size=32,
                            width=64, depth=2, heads=4, log_every=0,
                            cache_samples=256, device="cpu")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), losses[::10]
    assert np.isfinite(losses[-1])


def test_checkpoint_roundtrip(tmp_path):
    cfg = detector.ViTConfig(image_size=32, patch=16, width=64, depth=2,
                             heads=4)
    params = detector.init_params(3, cfg)
    ckpt = str(tmp_path / "ckpt")
    convert.save_checkpoint(ckpt, params, cfg)
    restored = convert.load_checkpoint(ckpt, cfg)
    fresh = detector.init_params(99, cfg)
    x = torch.from_numpy(np.random.default_rng(0).random((2, 32, 32, 3),
                                                         np.float32))
    out = detector.forward(params, x, cfg)
    assert torch.equal(detector.forward(restored, x, cfg), out)
    assert float((detector.forward(fresh, x, cfg) - out).abs().max()) > 1e-4


@pytest.mark.parametrize("experts", [0, 2])
def test_resume_bit_compatible(tmp_path, experts):
    """Killed after 3 steps and resumed: the final parameters and losses
    equal an uninterrupted run's bit for bit.  With experts the
    checkpoint stores the attention and expert leaves in bf16, so the
    resume must read the f32 master copy in ``<out>.train``."""
    kw = dict(TINY, seed=11, experts=experts)
    straight, l_straight = train.train(steps=6, **kw)
    out = str(tmp_path / "ckpt_resume")
    _, l_first = train.train(steps=3, out=out, **kw)
    assert os.path.isfile(out + ".train")
    with open(os.path.join(out, "train_meta.json")) as f:
        assert json.load(f)["steps"] == 3
    resumed, l_rest = train.train(steps=6, out=out, resume=True, **kw)
    _equal_trees(straight, resumed)
    assert l_first + l_rest == l_straight


def test_schedule_horizon_makes_phased_cosine_match_straight(tmp_path):
    kw = dict(TINY, seed=13, schedule="cosine", warmup=2)
    straight, _ = train.train(steps=6, **kw)
    out = str(tmp_path / "ckpt_horizon")
    train.train(steps=3, out=out, schedule_horizon=6, **kw)
    resumed, _ = train.train(steps=6, out=out, resume=True,
                             schedule_horizon=6, **kw)
    _equal_trees(straight, resumed)
    with open(os.path.join(out, "train_meta.json")) as f:
        assert json.load(f)["schedule_horizon"] == 6


def test_save_every_writes_intermediate_state(tmp_path):
    out = str(tmp_path / "ckpt_every")
    train.train(steps=4, out=out, save_every=2, **dict(TINY, seed=1))
    state = torch.load(out + ".train", weights_only=True)
    assert state["step"] == 4 and state["opt_state"]["count"] == 4


def test_accum_k_matches_mean_grad_step():
    """K update calls with micro-gradients equal one step with their mean
    (model-level parity with a K·B batch is not expected: the bf16
    backward rounds at batch-dependent scales, and Adam's first step
    amplifies that)."""
    rng = np.random.default_rng(0)
    p0 = [rng.random((8, 8)).astype(np.float32), np.zeros(8, np.float32)]
    g = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0]
         for _ in range(2)]
    opt_a = detector.make_optimizer(1e-3, accum=2)
    pa = [torch.from_numpy(p.copy()) for p in p0]
    sa = opt_a.init(pa)
    assert not opt_a.update(pa, [torch.from_numpy(x) for x in g[0]], sa)
    assert all(torch.equal(a, torch.from_numpy(b)) for a, b in zip(pa, p0))
    assert opt_a.update(pa, [torch.from_numpy(x) for x in g[1]], sa)
    opt_b = detector.make_optimizer(1e-3)
    pb = [torch.from_numpy(p.copy()) for p in p0]
    opt_b.update(pb, [torch.from_numpy((a + b) / 2)
                      for a, b in zip(*g)], opt_b.init(pb))
    for a, b in zip(pa, pb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_accum_end_to_end_trains():
    _, losses = train.train(steps=24, **dict(TINY, lr=3e-3, seed=9,
                                             accum=4))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < np.mean(losses[:6])


def test_warmup_schedule_first_step_is_identity():
    cfg = detector.make_config("small", image_size=16, width=32, depth=1,
                               heads=2)
    params = detector.init_params(4, cfg)
    before = [x.clone() for x in optim.leaves_of(params)]
    opt = detector.make_optimizer(1e-3, steps=10, warmup=4,
                                  schedule="cosine", grad_clip=1.0)
    step = detector.make_train_step(cfg, opt)
    f, y = train.synthetic_batch(np.random.default_rng(6), 4, 16, ("blobs",))
    f, y = torch.from_numpy(f), torch.from_numpy(y)
    state = opt.init(optim.leaves_of(params))
    params, state, loss = step(params, state, f, y)
    assert np.isfinite(float(loss))
    for a, b in zip(before, optim.leaves_of(params)):
        assert torch.equal(a, b.detach())
    for _ in range(4):
        params, state, _ = step(params, state, f, y)
    moved = max(float((a - b.detach()).abs().max())
                for a, b in zip(before, optim.leaves_of(params)))
    assert moved > 1e-5


def test_grad_clip_changes_the_update_and_stays_finite():
    cfg = detector.make_config("small", image_size=16, width=32, depth=1,
                               heads=2)
    f, y = train.synthetic_batch(np.random.default_rng(7), 8, 16, ("blobs",))
    f, y = torch.from_numpy(f), torch.from_numpy(y)
    outs = {}
    for name, clip in (("clipped", 1e-4), ("raw", 0.0)):
        params = detector.init_params(5, cfg)
        opt = detector.make_optimizer(1.0, grad_clip=clip)
        step = detector.make_train_step(cfg, opt)
        params, _, _ = step(params, opt.init(optim.leaves_of(params)), f, y)
        outs[name] = _leaves(params)
    for leaves in outs.values():
        assert all(torch.isfinite(x).all() for x in leaves)
    assert max(float((a - b).abs().max())
               for a, b in zip(outs["clipped"], outs["raw"])) > 0


def test_ema_saved_and_tracks(tmp_path):
    kw = dict(TINY, lr=3e-3, seed=13, ema=0.5)
    cfg = detector.make_config("full", image_size=16, patch=16, width=32,
                               depth=1, heads=2)
    ref = str(tmp_path / "ref")
    train.train(steps=6, out=ref, **kw)
    out = str(tmp_path / "ckpt_ema")
    train.train(steps=3, out=out, **kw)
    resumed, _ = train.train(steps=6, out=out, resume=True, **kw)
    assert os.path.isdir(out + ".ema")
    ema_straight = torch.load(ref + ".train", weights_only=True)["ema"]
    ema_resumed = torch.load(out + ".train", weights_only=True)["ema"]
    _equal_trees(ema_straight, ema_resumed)
    on_disk = convert.load_checkpoint(out + ".ema", cfg)
    _equal_trees(on_disk, ema_resumed)
    lp, le = _leaves(resumed), _leaves(ema_resumed)
    assert any(float((a - b).abs().max()) > 1e-7 for a, b in zip(lp, le))
    assert all(torch.isfinite(e).all() for e in le)


def test_frame_cellular_family():
    ai = np.stack([train._frame_cellular(np.random.default_rng(i), 64, True)
                   for i in range(8)])
    cam = np.stack([train._frame_cellular(np.random.default_rng(i), 64,
                                          False) for i in range(8)])
    assert ai.shape == cam.shape == (8, 64, 64, 3)
    np.testing.assert_array_equal(
        ai[3], train._frame_cellular(np.random.default_rng(3), 64, True))

    def hf_energy(x):
        return float(np.mean(np.abs(np.diff(x, axis=1)))
                     + np.mean(np.abs(np.diff(x, axis=2))))

    assert hf_energy(cam) > 1.5 * hf_energy(ai)
    assert "cellular" in train.TRAIN_FAMILIES


@pytest.mark.parametrize("family", ["vit", "cnn", "temporal"])
def test_logit_l2_regularizer(family):
    """loss(logit_l2=c) == loss() + c·mean(z²), for every family (the
    temporal family adds the per-frame head's term at its weight)."""
    rng = np.random.default_rng(0)
    if family == "temporal":
        cfg = temporal.make_config("small", image_size=32, width=32,
                                   depth=1, frame_depth=1, heads=2)
        params = temporal.init_params(0, cfg)
        x = torch.from_numpy(rng.random((2, 3, 32, 32, 3), np.float32))
        y = torch.from_numpy(np.array([[0, 1, 1], [1, 0, 0]], np.int32))
        out, aux = temporal.forward(params, x, cfg, return_aux=True)
        zs = [(out[..., 0], 1.0), (aux[..., 0], cfg.aux_frame_loss)]
        mod = temporal
    else:
        mod = detector if family == "vit" else cnn
        cfg = (detector.ViTConfig(image_size=32, patch=16, width=64,
                                  depth=1, heads=2) if family == "vit"
               else cnn.make_config("small", image_size=32))
        params = mod.init_params(0, cfg)
        x = torch.from_numpy(rng.random((4, 32, 32, 3), np.float32))
        y = torch.from_numpy(np.array([0, 1, 0, 1], np.int32))
        zs = [(mod.forward(params, x, cfg)[:, 0], 1.0)]
    with torch.no_grad():
        base = float(mod.loss_fn(params, x, y, cfg))
        reg = float(mod.loss_fn(params, x, y, cfg, logit_l2=0.5))
    want = sum(w * 0.5 * float(np.mean(z.detach().double().numpy() ** 2))
               for z, w in zs)
    np.testing.assert_allclose(reg - base, want, rtol=1e-4)


def test_augment_pool_codec_selective():
    from avd_tpu_torch.ingest import codec
    if not codec.available():
        pytest.skip("libav* encoder unavailable")
    frames, _ = train.synthetic_batch(np.random.default_rng(0), 16, 32,
                                      families=("blobs", "cellular"))
    out = train.augment_pool_codec(frames, 0.5, np.random.default_rng(1))
    assert out.shape == frames.shape
    changed = np.array([not np.array_equal(out[i], frames[i])
                        for i in range(16)])
    assert changed.sum() == 8
    assert float(np.mean((out[changed] - frames[changed]) ** 2)) < 0.05
    np.testing.assert_array_equal(
        train.augment_pool_codec(frames, 0.0, np.random.default_rng(0)),
        frames)


def test_aug_codec_without_an_encoder_raises(monkeypatch):
    from avd_tpu_torch.ingest import codec
    monkeypatch.setattr(codec, "available", lambda: False)
    frames = np.zeros((4, 16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="libav"):
        train.augment_pool_codec(frames, 0.5, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="libav"):
        train.train(steps=1, aug_codec=0.5, **TINY)


def test_train_driver_temporal():
    params, losses = train.train(steps=2, batch=4, image_size=32, width=64,
                                 depth=1, heads=2, log_every=0,
                                 cache_samples=32, arch="temporal",
                                 seq_len=4, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    cfg = temporal.make_config("small", image_size=32, width=64, depth=1,
                               heads=2)
    acc, auc = train.evaluate_sequences(params, cfg, n=16, t=4, batch=8,
                                        device="cpu")
    assert 0.0 <= acc <= 1.0 and 0.0 <= auc <= 1.0


@pytest.mark.parametrize("arch,kw", [("cnn", {}), ("vit", {"experts": 2})])
def test_train_driver_other_families(arch, kw, tmp_path):
    """The CNN and the Switch-MoE ViT through the driver; the written
    checkpoint serves (``convert.load_checkpoint`` of the family's
    config)."""
    out = str(tmp_path / arch)
    params, losses = train.train(steps=3, arch=arch, out=out,
                                 **dict(TINY, image_size=32), **kw)
    assert len(losses) == 3 and np.isfinite(losses).all()
    _, cfg = train._config(arch, 32, 32, 1, 2, kw.get("experts", 0), False)
    restored = convert.load_checkpoint(out, cfg)
    stored = set(convert.stored_bf16(cfg))
    for (name, a), b in zip(_named(restored), _leaves(params)):
        if name in stored:
            assert torch.equal(a, b.bfloat16().float()), name
        else:
            assert torch.equal(a, b), name


def _named(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v)
        elif isinstance(v, list):
            for x in v:
                yield from _named(x)
        else:
            yield k, v


def test_init_from_resolution_transfer(tmp_path):
    """A 128 px checkpoint warm-starts a 224 px fine-tune: only the
    positional embedding changes grid."""
    cfg128 = detector.ViTConfig(image_size=128, patch=16, width=32, depth=1,
                                heads=2)
    params = detector.init_params(0, cfg128)
    ck = str(tmp_path / "ck128")
    convert.save_checkpoint(ck, params, cfg128)
    p224, losses = train.train(steps=2, batch=2, image_size=224, width=32,
                               depth=1, heads=2, log_every=0,
                               cache_samples=2, init_from=ck, device="cpu")
    cfg224 = dataclasses.replace(cfg128, image_size=224)
    assert p224["pos_emb"].shape[0] == cfg224.tokens
    assert np.isfinite(losses).all()


def test_init_from_an_orbax_directory_names_the_converter(tmp_path):
    ck = tmp_path / "orbax"
    ck.mkdir()
    (ck / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="torch_convert_weights"):
        train.train(steps=1, init_from=str(ck), **TINY)


@pytest.mark.parametrize("flag,message", [
    ({"pp_stages": 2},
     "1 devices / depth 1 not divisible by 2 stages × 1 tp"),
    ({"pp_tp": 2}, "--pp-tp requires --pp (the 'model' axis rides the "
                   "pipeline mesh)"),
    ({"zero1": True}, "--zero1 needs >1 device (a data axis to shard the "
                      "optimizer state over)"),
    ({"fsdp": True}, "--fsdp needs >1 device")])
def test_multi_device_flags_raise(flag, message):
    """On one process the flags of training over several devices raise
    ``avd_tpu``'s one-device ``ValueError``s
    (``avd_tpu/models/train.py:576-651``)."""
    with pytest.raises(ValueError) as e:
        train.train(steps=1, **TINY, **flag)
    assert str(e.value) == message


def test_train_on_a_media_folder():
    """``--data``: the committed corpus of JPEGs and H.264 clips."""
    _, losses = train.train(steps=2, batch=4, image_size=32, width=32,
                            depth=1, heads=2, log_every=0,
                            data=os.path.join(REPO, "tests", "data",
                                              "corpus_v1"), device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_cli(tmp_path, capsys):
    out = str(tmp_path / "cli")
    assert train.main(["--steps", "2", "--batch", "4", "--image-size", "16",
                       "--width", "32", "--depth", "1", "--heads", "2",
                       "--cache-samples", "8",
                       "--out", out, "--device", "cpu"]) == 0
    assert "final loss" in capsys.readouterr().out
    with open(os.path.join(out, "train_meta.json")) as f:
        meta = json.load(f)
    assert meta["device"] == "cpu" and meta["steps"] == 2
