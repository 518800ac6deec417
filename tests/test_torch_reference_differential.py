"""The port against the reference itself, after
tests/test_reference_differential.py: the reference's own video analyzer
(pure cv2+numpy, loaded by file path from the read-only mount) and its
fusion against ``avd_tpu_torch`` on the CPU, on the same golden files,
decode included, end to end through fusion, with that file's tolerances.

Skips, as the JAX file does, where the reference is not mounted.
"""

import copy
import importlib.util
import os

import numpy as np
import pytest

from tests.conftest import REFERENCE_DIR, reference_available
from tests import fixtures

pytestmark = pytest.mark.skipif(not reference_available(),
                                reason="reference not mounted")

DEV = "cpu"


def _load_reference(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REFERENCE_DIR,
                                     f"app/analyzers/{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clips(tmp_path):
    out = {}
    for name, frames in (
            ("solid", fixtures.solid_clip(45, 96)),
            ("noise", fixtures.noise_clip(45, 96)),
            ("spliced", fixtures.spliced_clip(60, 96))):
        out[name] = fixtures.write_video(tmp_path / f"{name}.mp4", frames,
                                         fps=30.0)
    return out


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return _clips(tmp_path_factory.mktemp("refdiff_torch"))


def _neutral_audio(meta):
    dur = meta.get("duration") or 0.0
    return {"scores": {}, "flags_audio": {},
            "timeline": [0.5] * int(max(1, round(dur)))}


@pytest.mark.parametrize("name", ["solid", "noise", "spliced"])
def test_video_analyzer_vs_reference(golden, name):
    from avd_tpu_torch.analyzers import video as ours_mod
    from avd_tpu_torch.ingest import probe

    ref_mod = _load_reference("video")
    path = golden[name]
    meta = probe.probe_basic_meta(path)

    theirs = ref_mod.analyze(path, dict(meta))
    ours = ours_mod.analyze(path, dict(meta), device=DEV)

    assert len(ours["timeline"]) == len(theirs["timeline"]), name
    so, st = ours["summary"], theirs["summary"]
    assert so["dup_density"] == st["dup_density"], name
    assert so["w"] == st["w"] and so["h"] == st["h"]
    assert abs(so["texture_var"] - st["texture_var"]) <= \
        1e-3 * max(1.0, st["texture_var"]), name
    assert abs(so["flow_mean"] - st["flow_mean"]) <= \
        0.10 * max(0.2, st["flow_mean"]), name
    np.testing.assert_allclose(ours["timeline"], theirs["timeline"],
                               atol=0.02, err_msg=name)


@pytest.mark.parametrize("name", ["solid", "noise", "spliced"])
def test_end_to_end_verdict_vs_reference(golden, name):
    """Reference video analyzer + reference fusion against the port end to
    end: identical labels, |Δai_score| ≤ 0.01 (the rounding quantum)."""
    from avd_tpu_torch.analyzers import fusion as our_fusion
    from avd_tpu_torch.analyzers import heuristics_v2
    from avd_tpu_torch.analyzers import video as our_video
    from avd_tpu_torch.ingest import probe

    ref_video = _load_reference("video")
    ref_fusion = _load_reference("fusion")

    path = golden[name]
    meta = probe.probe_basic_meta(path)
    hints = heuristics_v2.compute_hints(meta, path)
    neutral_audio = _neutral_audio(meta)

    theirs_v = ref_video.analyze(path, dict(meta))
    ours_v = our_video.analyze(path, dict(meta), device=DEV)

    theirs = ref_fusion.fuse(copy.deepcopy(neutral_audio),
                             copy.deepcopy(theirs_v), copy.deepcopy(hints))
    ours = our_fusion.fuse(copy.deepcopy(neutral_audio),
                           copy.deepcopy(ours_v), copy.deepcopy(hints))

    assert ours["result"]["label"] == theirs["result"]["label"], name
    assert abs(ours["result"]["ai_score"]
               - theirs["result"]["ai_score"]) <= 0.01, name
    assert abs(ours["result"]["confidence"]
               - theirs["result"]["confidence"]) <= 0.01, name


def test_end_to_end_1080p_vs_reference(tmp_path):
    """Full-resolution parity: a 1080p clip with motion and texture
    through the reference's own analyze() and the port's, decode
    included, then both fusions: |Δ| of the raw timeline ≤ 1e-3 a frame,
    identical label, ai_score and peaks."""
    from avd_tpu_torch.analyzers import fusion as our_fusion
    from avd_tpu_torch.analyzers import heuristics_v2
    from avd_tpu_torch.analyzers import video as our_video
    from avd_tpu_torch.ingest import probe

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (1080 + 64, 1920 + 64, 3),
                        dtype=np.int16).astype(np.uint8)
    try:
        import cv2
        base = cv2.GaussianBlur(base, (0, 0), 2)
    except Exception:
        pass
    frames = np.empty((150, 1080, 1920, 3), np.uint8)
    for i in range(150):
        dy, dx = (i * 3) % 64, (i * 5) % 64
        frames[i] = base[dy:dy + 1080, dx:dx + 1920]
    path = fixtures.write_video(tmp_path / "hd.mp4", frames, fps=30.0)

    ref_video = _load_reference("video")
    ref_fusion = _load_reference("fusion")
    meta = probe.probe_basic_meta(path)
    hints = heuristics_v2.compute_hints(meta, path)
    neutral_audio = _neutral_audio(meta)

    theirs_v = ref_video.analyze(path, dict(meta))
    ours_v = our_video.analyze(path, dict(meta), device=DEV)

    assert ours_v["summary"]["w"] == 1920
    assert ours_v["summary"]["dup_density"] == \
        theirs_v["summary"]["dup_density"]
    # per-frame budget 1e-3 on the raw pre-rounding timeline
    np.testing.assert_allclose(ours_v["timeline"], theirs_v["timeline"],
                               atol=1e-3)

    theirs = ref_fusion.fuse(copy.deepcopy(neutral_audio),
                             copy.deepcopy(theirs_v), copy.deepcopy(hints))
    ours = our_fusion.fuse(copy.deepcopy(neutral_audio),
                           copy.deepcopy(ours_v), copy.deepcopy(hints))

    assert ours["result"]["label"] == theirs["result"]["label"]
    assert abs(float(np.mean(ours["timeline_binned"]))
               - float(np.mean(theirs["timeline_binned"]))) <= 1e-3
    assert ours["result"]["ai_score"] == theirs["result"]["ai_score"]
    assert ours["peaks"] == theirs["peaks"]
