"""Exported detector programs (``avd_tpu_torch/models/export.py``) on the
CPU: the cases of ``tests/test_export.py`` on the port, every family
through ``AVD_DETECTOR_EXPORTED``, and the port's artifact against
``avd_tpu``'s exported program on the same weights.

The port traces the same f32 computation the eager bundle runs, so on the
CPU its probabilities equal the eager bundle's within 1e-6 (measured: 0).
Against ``avd_tpu``'s jax.export program the bf16 forward differs between
the two compilers: within 1e-2, the bound of ``tests/test_export.py``.
"""

import http.client
import json
import os
import runpy
import sys
import threading

import numpy as np
import pytest
import torch

from avd_tpu_torch import config as config_mod
from avd_tpu_torch.models import convert, detector, scoring, temporal
from avd_tpu_torch.models import export as export_mod
from tests import fixtures

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_VIT = dict(image_size=32, patch=16, width=128, depth=2, heads=4)
TINY_TEMPORAL = dict(image_size=32, patch=16, width=64, depth=2,
                     frame_depth=2, heads=2)
_ENV = ("AVD_DETECTOR", "AVD_DETECTOR_EXPORTED", "AVD_DETECTOR_ARCH",
        "AVD_DETECTOR_PRESET", "AVD_DETECTOR_CKPT", "AVD_DETECTOR_TEMP",
        "AVD_DETECTOR_QUANT", "AVD_ATTN_FUSED", "AVD_DETECTOR_BLEND",
        "AVD_TEMPORAL_WINDOW")


@pytest.fixture
def env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    scoring._bundle.cache_clear()
    yield monkeypatch
    scoring._bundle.cache_clear()
    config_mod.reset_config()


def _rand_frames(n, size, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3), np.float32)


def _export(tmp_path, name="artifact", **kw):
    out = str(tmp_path / name)
    kw.setdefault("arch", "vit")
    kw.setdefault("preset", "small")
    kw.setdefault("ckpt", None)
    if kw["arch"] == "vit":
        kw.setdefault("config_overrides", TINY_VIT)
    return out, export_mod.export_detector(out, device="cpu", **kw)


def _eager(arch, preset, over, x, temp=1.0, n_valid=None):
    fam, cfg, _, params, _, _ = export_mod._build(arch, preset, None, over)
    params = fam.cast_for_inference(params, "cpu")
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        if n_valid is None:
            z = fam.forward(params, xt, cfg)
        else:
            z = fam.forward_clip(params, xt, cfg,
                                 mask=torch.arange(x.shape[0]) < n_valid)
    return torch.sigmoid(z[:, 0].float() / temp).numpy()


def test_export_roundtrip_vit(tmp_path):
    out, manifest = _export(tmp_path, batch=8)
    assert manifest["batch"] == 8 and manifest["image_size"] == 32
    assert manifest["source"] == "random_init"
    assert manifest["devices"] == ["cpu", "cuda"]
    assert manifest["traced_on"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["program_bytes"] == os.path.getsize(
        os.path.join(out, export_mod.PROGRAM_FILE))
    cfg, params, probs, source = export_mod.load_bundle(out, "cpu")
    assert params is None and probs.fixed_batch == 8
    assert cfg.image_size == 32 and source == "exported:random_init"
    x = _rand_frames(8, 32)
    got = probs(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _eager("vit", "small", TINY_VIT, x),
                               atol=1e-6, rtol=0)


def test_export_temperature_baked_in(tmp_path, env):
    cfg = detector.make_config("small", **TINY_VIT)
    ckpt = str(tmp_path / "ckpt")
    convert.save_checkpoint(ckpt, detector.init_params(0, cfg), cfg)
    with open(os.path.join(ckpt, "calibration.json"), "w") as f:
        json.dump({"temperature": 2.0}, f)
    env.setenv("AVD_DETECTOR_TEMP", "5.0")  # a serving knob: not baked
    with pytest.warns(UserWarning, match="IGNORED by export"):
        out, manifest = _export(tmp_path, ckpt=ckpt, batch=4)
    env.delenv("AVD_DETECTOR_TEMP")
    assert manifest["temperature"] == 2.0 and manifest["source"] == ckpt
    _, _, probs, source = export_mod.load_bundle(out, "cpu")
    assert "+T2.00" in source
    x = _rand_frames(4, 32, seed=3)
    np.testing.assert_allclose(
        probs(torch.from_numpy(x)).numpy(),
        _eager("vit", "small", TINY_VIT, x, temp=2.0), atol=1e-6, rtol=0)


def test_export_temporal_masked_window(tmp_path):
    out, manifest = _export(tmp_path, arch="temporal", window=8,
                            config_overrides=TINY_TEMPORAL)
    assert manifest["window"] == 8
    _, _, probs, _ = export_mod.load_bundle(out, "cpu")
    assert probs.clip_window == 8
    frames = _rand_frames(5, 32, seed=1)
    padded = np.concatenate([frames, np.repeat(frames[-1:], 3, axis=0)])
    got = probs(torch.from_numpy(padded), 5).numpy()[:5]
    want = _eager("temporal", "small", TINY_TEMPORAL, padded, n_valid=5)[:5]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # padded positions do not move the real frames' scores
    other = np.concatenate([frames, _rand_frames(3, 32, seed=9)])
    np.testing.assert_allclose(probs(torch.from_numpy(other), 5).numpy()[:5],
                               got, atol=1e-6, rtol=0)


def test_tampered_artifact_fails_loudly(tmp_path):
    out, _ = _export(tmp_path, batch=2)
    path = os.path.join(out, export_mod.PROGRAM_FILE)
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="sha256 mismatch"):
        export_mod.load_bundle(out, "cpu")


def test_manifest_guards(tmp_path):
    out, _ = _export(tmp_path, batch=2, devices=("cpu",))
    mpath = os.path.join(out, export_mod.MANIFEST_FILE)
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["devices"] = ["cuda"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="exported for"):
        export_mod.load_bundle(out, "cpu")
    manifest["format_version"] = 99
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="format 99"):
        export_mod.load_bundle(out, "cpu")
    with pytest.raises(ValueError, match="fused_attn"):
        _export(tmp_path, name="fused",
                config_overrides=dict(TINY_VIT, fused_attn=True))
    with pytest.raises(ValueError, match="does not list"):
        _export(tmp_path, name="nocpu", devices=("cuda",))


def _post(port, path):
    with open(path, "rb") as f:
        payload = f.read()
    boundary = "avdexportboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"file\"; filename=\"clip.mp4\"\r\n"
            f"Content-Type: application/octet-stream\r\n\r\n"
            ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/analyze", body=body, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}",
        "Content-Length": str(len(body))})
    r = conn.getresponse()
    env = json.loads(r.read())
    conn.close()
    return r.status, env


def test_http_serving_from_artifact(tmp_path, env):
    """The app serves detector scores from the artifact: the setting runs
    through build_app → pipeline → analyzer → scoring, and the envelope's
    detector block names the exported program."""
    from avd_tpu_torch.serve import app as app_mod
    from avd_tpu_torch.serve import http as http_mod
    out, _ = _export(tmp_path, batch=4)
    env.setenv("AVD_BACKEND", "oracle")
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_EXPORTED", out)
    config_mod.reset_config()
    srv = http_mod.make_server(app_mod.build_app(device="cpu"), "127.0.0.1",
                               0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        path = fixtures.write_video(tmp_path / "clip.mp4",
                                    fixtures.noise_clip(10, 64), fps=30.0)
        status, envelope = _post(srv.server_address[1], path)
    finally:
        srv.shutdown()
        srv.server_close()
    assert status == 200
    det = envelope["video"].get("detector")
    assert det and det["weights"].startswith("exported:")
    assert len(det["timeline"]) > 0


def test_scoring_serves_from_artifact(tmp_path, env):
    """Through ``detector_timeline``, including the chunk-and-pad path for
    a frame count the traced batch does not divide."""
    out, _ = _export(tmp_path, batch=4)
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_EXPORTED", out)
    frames = np.random.default_rng(7).integers(0, 256, (6, 32, 32, 3),
                                                dtype=np.uint8)
    det = scoring.detector_timeline(frames, device="cpu")
    assert len(det["timeline"]) == 6
    assert det["weights"].startswith("exported:")
    x = frames[..., ::-1].astype(np.float32) / 255.0
    np.testing.assert_allclose(det["timeline"],
                               _eager("vit", "small", TINY_VIT, x),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch,preset", [("cnn", "small"),
                                         ("temporal", "small"),
                                         ("vit", "moe_small")])
def test_every_family_serves_its_shipped_weights_exported(tmp_path, env,
                                                          arch, preset):
    """The shipped checkpoint exported and served through scoring equals
    the eager bundle on the same frames within 1e-6."""
    out, manifest = _export(tmp_path, arch=arch, preset=preset, ckpt="auto",
                            batch=8, window=8, config_overrides=None)
    assert manifest["source"] == scoring._shipped_ckpt(arch, preset)
    frames = np.random.default_rng(2).integers(0, 256, (11, 64, 64, 3),
                                                dtype=np.uint8)
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_ARCH", arch)
    env.setenv("AVD_DETECTOR_PRESET", preset)
    env.setenv("AVD_TEMPORAL_WINDOW", "8")
    eager = scoring.detector_timeline(frames, device="cpu")
    env.setenv("AVD_DETECTOR_EXPORTED", out)
    scoring._bundle.cache_clear()
    served = scoring.detector_timeline(frames, device="cpu")
    assert served["weights"] == "exported:" + eager["weights"]
    np.testing.assert_allclose(served["timeline"], eager["timeline"],
                               atol=1e-6, rtol=0)


def test_analyze_path_serves_the_artifact(tmp_path, env):
    from avd_tpu_torch import pipeline
    out, _ = _export(tmp_path, arch="temporal", preset="small", ckpt="auto",
                     window=32, config_overrides=None)
    path = fixtures.write_video(tmp_path / "s.mp4",
                                fixtures.spliced_clip(30, 64), fps=30.0)
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_ARCH", "temporal")
    eager = pipeline.analyze_path(str(path), device="cpu")
    env.setenv("AVD_DETECTOR_EXPORTED", out)
    scoring._bundle.cache_clear()
    served = pipeline.analyze_path(str(path), device="cpu")
    assert "detector_error" not in served["video"]
    np.testing.assert_allclose(served["video"]["detector"]["timeline"],
                               eager["video"]["detector"]["timeline"],
                               atol=1e-6, rtol=0)


def test_port_artifact_matches_avd_tpu_exported_program(tmp_path):
    """The same weights through both packages' exported programs: the
    port's artifact of the converted tree against ``avd_tpu``'s
    jax.export program within 1e-2."""
    import jax
    import jax.numpy as jnp
    from avd_tpu.models import detector as jdetector
    from avd_tpu.models import export as jexport

    jout = str(tmp_path / "jax_artifact")
    jexport.export_detector(jout, arch="vit", preset="small", ckpt=None,
                            batch=4, platforms=("cpu",),
                            config_overrides=TINY_VIT)
    _, _, jprobs, _, _ = jexport.load_bundle(jout)
    jcfg = jdetector.make_config("small", **TINY_VIT)
    jparams = jax.tree_util.tree_map(
        np.asarray, jdetector.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = detector.make_config("small", **TINY_VIT)
    ckpt = str(tmp_path / "converted")
    convert.save_checkpoint(ckpt, convert.from_jax_params(jparams, cfg), cfg)
    out, _ = _export(tmp_path, ckpt=ckpt, batch=4)
    _, _, probs, _ = export_mod.load_bundle(out, "cpu")
    x = _rand_frames(4, 32, seed=5)
    want = np.asarray(jprobs(None, jnp.asarray(x)))
    got = probs(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_cli_and_tool(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "cli")
    assert export_mod.main(["--out", out, "--arch", "temporal", "--ckpt",
                            "none", "--window", "4", "--device", "cpu",
                            "--devices", "cpu"]) == 0
    with open(os.path.join(out, export_mod.MANIFEST_FILE)) as f:
        manifest = json.load(f)
    assert manifest["window"] == 4 and manifest["devices"] == ["cpu"]
    tool = os.path.join(REPO, "tools", "torch_export_detector.py")
    monkeypatch.setattr(sys, "argv", [tool, "--help"])
    with pytest.raises(SystemExit) as e:
        runpy.run_path(tool, run_name="__main__")
    assert e.value.code == 0 and "--device" in capsys.readouterr().out


def test_temporal_program_takes_a_zero_d_count(tmp_path):
    """n_valid is an input of the program, not a constant traced in."""
    out, _ = _export(tmp_path, arch="temporal", window=4,
                     config_overrides=TINY_TEMPORAL)
    _, _, probs, _ = export_mod.load_bundle(out, "cpu")
    x = torch.from_numpy(_rand_frames(4, 32, seed=4))
    cfg = temporal.make_config("small", **TINY_TEMPORAL)
    assert cfg.image_size == 32
    a, b = probs(x, 2).numpy(), probs(x, 4).numpy()
    np.testing.assert_allclose(
        a, _eager("temporal", "small", TINY_TEMPORAL, x.numpy(), n_valid=2),
        atol=1e-6, rtol=0)
    assert np.abs(a[:2] - b[:2]).max() > 0
