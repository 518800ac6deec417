"""One served worker over a rank group (``serve/group.py``), on the CPU.

A leader process (``tests/torch_group_programs.py``) starts a group of 2
and of 3 gloo ranks itself, as a served worker does, and enters the
group's calls through the port's entry points; it and its followers
import neither ``jax`` nor ``avd_tpu``.  Held against the single-process
port and ``avd_tpu`` (its scoring sharded over the suite's 8-device
virtual mesh), computed in this process:

* scoring through the group: probabilities within 2e-2 of both;
* ``analyze_batch`` through the group (the context-parallel pairs and the
  sharded detector): the envelope built from it against the one built
  from ``avd_tpu``'s: |Δai_score| <= 1e-3, the same label, the detector
  timeline within 2e-2;
* ``compute_features`` through the group: rtol 1e-5 of the single-process
  port (the bound of ``tests/test_torch_parallel.py``);
* 8 threads at once, each its own clip: each gets its own single-process
  answer (no cross-talk, no deadlock);
* int8 and the temporal family under a group: scored on the leader alone
  (no group call), int8 with ``avd_tpu``'s warning.

Then the real master, ``--device cpu --group-size 2``: it boots and
``/readyz`` says 2 devices; an upload with ``AVD_DETECTOR=1`` equals the
one-rank envelope; a killed follower and a hung (stopped) one each make
the worker exit and the master respawn a group that serves, as does a
follower killed while the respawned group forms; ``SIGHUP``
replaces the group; ``SIGTERM`` leaves no process of it, every check by
pid.  Every wait has its own deadline.
"""

import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from avd_tpu.analyzers import video as jvideo
from avd_tpu.models import scoring as jscoring
from avd_tpu_torch import config as cfg_mod
from avd_tpu_torch import pipeline
from avd_tpu_torch.analyzers import heuristics_v2 as hx
from avd_tpu_torch.analyzers import video as video_an
from avd_tpu_torch.models import scoring
from avd_tpu_torch.ops import audio_features, video_features
from avd_tpu_torch.parallel import dryrun
from tests import fixtures, torch_group_programs as programs
from tests.test_torch_master import _free_port, _get, _read, _wait_for

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-2
SIZES = (2, 3)
_ENV = ("AVD_DETECTOR", "AVD_DETECTOR_ARCH", "AVD_DETECTOR_PRESET",
        "AVD_ATTN_FUSED", "AVD_DETECTOR_QUANT", "AVD_DETECTOR_CKPT",
        "AVD_DETECTOR_TEMP", "AVD_DETECTOR_EXPORTED", "AVD_DETECTOR_SLAB",
        "AVD_DETECTOR_BLEND", "AVD_STREAM", "AVD_CP")


def _inputs():
    rng = np.random.default_rng(7)
    out = {"resized": rng.integers(0, 256, (5, 64, 64, 3)).astype(np.uint8),
           "clip": dryrun.demo_clip(12, 96, 128, seed=0)}
    for i in range(programs.THREADS):
        out[f"clip_{i}"] = dryrun.demo_clip(6, 64, 80, seed=10 + i)
    return out


@pytest.fixture(scope="module")
def settings():
    """The leader's detector settings in this process, the bundle rebuilt
    on entry and exit."""
    with pytest.MonkeyPatch.context() as mp:
        for k in _ENV:
            mp.delenv(k, raising=False)
        for k, v in programs.SETTINGS.items():
            mp.setenv(k, v)
        scoring._bundle.cache_clear()
        jscoring._bundle.cache_clear()
        cfg_mod.reset_config()
        yield
    scoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def leaders(tmp_path_factory, inputs, settings):
    """Both leaders started at once (each a subprocess with its
    followers), before this process computes its references."""
    procs = {}
    for n in SIZES:
        work = str(tmp_path_factory.mktemp(f"group{n}"))
        np.savez(os.path.join(work, "inputs.npz"), **inputs)
        log = open(os.path.join(work, "leader.log"), "w")
        procs[n] = (work, log, subprocess.Popen(
            [sys.executable, "-m", "tests.torch_group_programs", str(n),
             work], cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    yield procs
    for _, log, p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
        log.close()


@pytest.fixture(scope="module")
def groups(leaders, single, jax_ref):
    """{size: (arrays, info)} of each leader, once it has ended."""
    out = {}
    for n, (work, log, p) in leaders.items():
        p.wait(timeout=300)
        log.flush()
        assert p.returncode == 0, _read(os.path.join(work, "leader.log"))
        with np.load(os.path.join(work, "results.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(work, "results.json")) as f:
            out[n] = (arrays, json.load(f))
        for pid in out[n][1]["pids"]:
            assert not _alive(pid), f"rank pid {pid} outlived its group"
    return out


def _batch(frames):
    return programs._batch(frames)


@pytest.fixture(scope="module")
def single(inputs, settings):
    """The port on one CPU process, no group."""
    dev = torch.device("cpu")
    out = {"probs": np.asarray(scoring.detector_timeline_resized(
        inputs["resized"], dev)["timeline"]),
        "video": video_an.analyze_batch(_batch(inputs["clip"]), device=dev),
        "features": video_features.compute_features(inputs["clip"], dev),
        "threads": [video_an.analyze_batch(_batch(inputs[f"clip_{i}"]),
                                           device=dev)
                    for i in range(programs.THREADS)]}
    for mode, env in (("int8", {"AVD_DETECTOR_QUANT": "1"}),
                      ("temporal", {"AVD_DETECTOR_ARCH": "temporal"})):
        os.environ.update(env)
        scoring._bundle.cache_clear()
        try:
            out[mode] = np.asarray(scoring.detector_timeline(
                inputs["clip"], dev)["timeline"])
        finally:
            for k in env:
                del os.environ[k]
            scoring._bundle.cache_clear()
    return out


@pytest.fixture(scope="module")
def jax_ref(inputs, settings):
    """``avd_tpu`` on its 8-device virtual mesh: sharded scores and the
    batch analyzer's video block (its CP pairs and sharded detector)."""
    return {"probs": np.asarray(jscoring.detector_timeline_resized(
        inputs["resized"])["timeline"]),
        "video": jvideo.analyze_batch(_batch(inputs["clip"]))}


def _envelope(video):
    meta = {"width": 128, "height": 96, "fps": 8.0, "duration": 1.5}
    audio = audio_features.analyze_waveform(np.zeros(16000, np.float32),
                                            16000, device="cpu")
    return pipeline.envelope(meta, hx.compute_hints(meta, ""), video, audio)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:  # a zombie child of this process is gone for our purposes
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


@pytest.mark.parametrize("n", SIZES)
def test_group_scoring_equals_one_process_and_avd_tpu(groups, single,
                                                      jax_ref, n):
    probs = groups[n][0]["probs"]
    assert probs.shape == (5,)
    np.testing.assert_allclose(probs, single["probs"], atol=ATOL)
    np.testing.assert_allclose(probs, jax_ref["probs"], atol=ATOL)
    calls = groups[n][1]["stats"]["calls"]
    assert calls["warm"]["n"] == 1 and calls["score_resized"]["n"] >= 1


@pytest.mark.parametrize("n", SIZES)
def test_group_envelope_equals_avd_tpu(groups, single, jax_ref, n):
    """The batch analyzer through the group: both group calls."""
    video = groups[n][1]["video"]
    assert "detector_error" not in video
    for ref in (single["video"], jax_ref["video"]):
        ours, theirs = _envelope(video), _envelope(ref)
        assert ours["result"]["label"] == theirs["result"]["label"]
        d = abs(ours["result"]["ai_score"] - theirs["result"]["ai_score"])
        assert d <= 1e-3, d
        np.testing.assert_allclose(video["detector"]["timeline"],
                                   ref["detector"]["timeline"], atol=ATOL)
    assert video["summary"]["dup_density"] == \
        single["video"]["summary"]["dup_density"]


@pytest.mark.parametrize("n", SIZES)
def test_group_cp_features_equal_one_process(groups, single, n):
    arrays, info = groups[n]
    ref = single["features"]
    for k in ("flow_means", "flow_vars", "textures", "timeline_ai"):
        np.testing.assert_allclose(arrays[f"features/{k}"], ref[k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert info["features_dup"] == ref["dup"]
    # the pairs ran on every rank: each rank's collectives are its own
    ranks = info["stats"]["ranks"]
    assert len(ranks) == n
    for r in ranks:
        assert r["collectives"]["ppermute/gloo"] >= 1
        assert r["collectives"]["all_gather/gloo"] >= 1


@pytest.mark.parametrize("n", SIZES)
def test_concurrent_threads_get_their_own_answers(groups, single, n):
    got = groups[n][1]["threads"]
    assert len(got) == programs.THREADS
    for i, (ours, ref) in enumerate(zip(got, single["threads"])):
        assert "detector_error" not in ours, i
        np.testing.assert_allclose(ours["detector"]["timeline"],
                                   ref["detector"]["timeline"], atol=ATOL,
                                   err_msg=f"clip {i}")
        np.testing.assert_allclose(ours["timeline"], ref["timeline"],
                                   rtol=1e-5, atol=1e-6, err_msg=f"clip {i}")
        assert ours["summary"]["flow_mean"] == pytest.approx(
            ref["summary"]["flow_mean"], rel=1e-5)
    # every clip went through the group: 8 CP and 8 scoring calls at least
    calls = groups[n][1]["stats"]["calls"]
    assert calls["cp_pairs"]["n"] >= programs.THREADS + 2


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", ["int8", "temporal"])
def test_single_rank_families_score_on_the_leader(groups, single, n, mode):
    arrays, info = groups[n]
    np.testing.assert_allclose(arrays[f"single/{mode}"], single[mode],
                               atol=1e-6)
    rec = info[f"single/{mode}"]
    before, after = rec["group_calls"]
    assert before == after  # no call went to the group
    said = any("AVD_DETECTOR_QUANT=1 serves SINGLE-RANK" in w
               for w in rec["warnings"])
    assert said == (mode == "int8")
    if mode == "int8":
        assert rec["weights"].endswith("+int8")


# ---------------------------------------------------------------------------
# the group a worker forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,cards,size,backend,want", [
    ("cuda", 1, 0, None, (0, None)),       # one card: today's path
    ("cuda", 4, 0, None, (4, "nccl")),     # every visible card
    ("cuda", 1, 1, None, (1, "nccl")),     # a group of one over NCCL
    ("cuda", 1, 2, "gloo", (2, "gloo")),   # gloo ranks share a card
    ("cpu", 0, 0, None, (0, None)),
    ("cpu", 0, 2, None, (2, "gloo")),
])
def test_plan_of_a_workers_group(monkeypatch, device, cards, size, backend,
                                 want):
    from avd_tpu_torch.serve import group
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert group.plan(device, size, backend) == want


@pytest.mark.parametrize("device,cards,size,backend,said", [
    ("cuda", 1, 2, None, "2 NCCL ranks on 1 visible card"),
    ("cuda", 2, 3, "nccl", "3 NCCL ranks on 2 visible card"),
    ("cpu", 0, 2, "nccl", "needs --device cuda"),
])
def test_plan_refuses_more_nccl_ranks_than_cards(monkeypatch, device, cards,
                                                 size, backend, said):
    from avd_tpu_torch.serve import group
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(ValueError, match=said):
        group.plan(device, size, backend)


def test_served_mesh_sub_groups_time_out_with_the_group(tmp_path):
    """A served group's (data, model) mesh over 4 ranks: its "model"
    sub-groups take the group's collective timeout (3 s here), so rank 0
    waiting on a rank 8 s late raises within it, where torch's default
    sub-group would have waited the 8 s out."""
    reports = dryrun.launch(
        4, "cpu", [{"name": "m", "kind": "tests.torch_group_programs:"
                    "served_mesh", "rank": 1, "late_s": 8.0}],
        spec=dryrun.small_spec(), timeout_s=120, collective_timeout_s=3,
        workdir=str(tmp_path))
    info = {r["rank"]: r["programs"]["m"]["info"] for r in reports}
    assert info[0]["shape"] == {"data": 2, "model": 2}
    assert info[0]["raised"] and info[0]["s"] < 6.0, info[0]
    assert not info[2]["raised"] and not info[3]["raised"], info


# ---------------------------------------------------------------------------
# the real master
# ---------------------------------------------------------------------------

# a collective timeout (the worker's hang timer) short enough for the hung
# case to wait out, and the streaming path alone (AVD_CP=0): on a loaded
# host the warm-up's context-parallel call can outlive that timeout, and
# the group's pairs are held by the leader cases above
MASTER_ENV = {"GUNICORN_TIMEOUT": "20", "AVD_CP": "0",
              "GUNICORN_GRACEFUL_TIMEOUT": "2",
              "WEB_CONCURRENCY": "1", "GUNICORN_MAX_REQUESTS": "0",
              **programs.SETTINGS}


class _Master:
    def __init__(self, tmp, group_size=2):
        self.port = _free_port()
        self.log = str(tmp / f"master_{self.port}.log")
        env = {k: v for k, v in os.environ.items() if k not in _ENV}
        env.update(MASTER_ENV, GUNICORN_BIND=f"127.0.0.1:{self.port}")
        with open(self.log, "w") as lf:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "avd_tpu_torch.serve.master",
                 "--device", "cpu", "--group-size", str(group_size)],
                env=env, cwd=REPO, stdout=lf, stderr=subprocess.STDOUT)

    def text(self):
        return _read(self.log)

    def group(self, timeout=90.0, exclude=()):
        """The serving group's pids from ``/metrics`` (a group other than
        ``exclude``'s), once it answers."""
        def get():
            try:
                st, body = _get(self.port, "/metrics", timeout=5)
            except OSError:
                return None
            pids = body["metrics"].get("group", {}).get("pids") \
                if st == 200 else None
            return pids if pids and pids[0] not in exclude else None
        return _wait_for(get, "a serving group", timeout, self.log)

    def upload(self, path, timeout=120):
        from avd_tpu_torch.client import Client
        return Client(f"http://127.0.0.1:{self.port}", timeout=timeout,
                      retries=0).analyze(path).raw

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


def _gone(pids, master, timeout=30.0):
    _wait_for(lambda: not any(_alive(p) for p in pids),
              f"pids {pids} to exit", timeout, master.log)


@pytest.fixture(scope="module")
def clip_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    return fixtures.write_video(path, dryrun.demo_clip(16, 64, 64, seed=3),
                                fps=8.0)


@pytest.fixture(scope="module")
def one_rank_envelope(clip_path, settings):
    """The one-rank worker's envelope: the same settings, no group."""
    return pipeline.analyze_path(clip_path, device="cpu")


@pytest.fixture(scope="module")
def master(tmp_path_factory):
    m = _Master(tmp_path_factory.mktemp("master"))
    yield m
    m.stop()


def _same(served, ref):
    assert "detector_error" not in served["video"], served["video"]
    assert served["result"]["label"] == ref["result"]["label"]
    assert abs(served["result"]["ai_score"]
               - ref["result"]["ai_score"]) <= 1e-3
    np.testing.assert_allclose(served["video"]["detector"]["timeline"],
                               ref["video"]["detector"]["timeline"],
                               atol=ATOL)
    np.testing.assert_allclose(served["video"]["timeline"],
                               ref["video"]["timeline"], atol=1e-6)


def test_master_group_boots_and_reports_its_devices(master):
    pids = master.group()
    assert len(pids) == 2
    st, ready = _get(master.port, "/readyz")
    assert st == 200 and ready["cuda"]["devices"] == 2
    text = master.text()
    assert "rank group of 2 over gloo on cpu" in text
    assert "failed to boot" not in text and "Traceback" not in text


def test_master_group_upload_equals_one_rank(master, clip_path,
                                             one_rank_envelope):
    master.group()
    _same(master.upload(clip_path), one_rank_envelope)
    _, body = _get(master.port, "/metrics")
    g = body["metrics"]["group"]
    assert g["calls"]["score_resized"]["n"] >= 1
    assert len(g["ranks"]) == 2


@pytest.mark.parametrize("fault", ["killed", "hung"])
def test_failed_follower_respawns_the_group(master, clip_path,
                                            one_rank_envelope, fault):
    old = master.group()
    dead = master.text().count("rank group failed")
    if fault == "killed":
        os.kill(old[1], signal.SIGKILL)
    else:  # stopped: the next call waits on it until the group's timeout
        os.kill(old[1], signal.SIGSTOP)
        try:
            master.upload(clip_path, timeout=60)
        except Exception:
            pass  # the worker may exit under the request
    _wait_for(lambda: master.text().count("rank group failed") > dead,
              "the group to fail", 30, master.log)
    _gone(old, master)
    new = master.group(exclude=old)
    assert not set(new) & set(old)
    assert re.search(rf"worker {old[0]} died \(exit 4\)", master.text())
    _same(master.upload(clip_path), one_rank_envelope)


def test_group_that_fails_to_form_is_respawned(master, clip_path,
                                              one_rank_envelope):
    """A follower killed while a respawned group forms: its worker exits
    ``GROUP_FAILED`` (not the boot error, which would stop the master),
    and the master respawns it again and serves."""
    old = master.group()
    starts = master.text().count("starting followers")
    os.kill(old[1], signal.SIGKILL)

    def forming():
        found = re.findall(r"\[worker (\d+)\] starting followers \[(\d+)",
                           master.text())
        return found[starts] if len(found) > starts else None
    leader, follower = map(int, _wait_for(forming, "a new group's "
                                          "followers", 60, master.log))
    os.kill(follower, signal.SIGKILL)
    _wait_for(lambda: re.search(rf"worker {leader} died \(exit 4\)",
                                master.text()),
              "the forming group's worker to exit", 60, master.log)
    assert f"[worker {leader}] rank group failed to form" in master.text()
    new = master.group(exclude=old + [leader])
    assert master.proc.poll() is None
    assert "failed to boot" not in master.text()
    _same(master.upload(clip_path), one_rank_envelope)
    assert not set(new) & set(old + [leader, follower])


def test_sighup_replaces_the_group(master, clip_path, one_rank_envelope):
    old = master.group()
    master.proc.send_signal(signal.SIGHUP)
    _gone(old, master, timeout=90)
    new = master.group(exclude=old)
    _same(master.upload(clip_path), one_rank_envelope)
    assert len(new) == 2


def test_sigterm_leaves_no_process_of_the_group(master):
    pids = master.group()
    master.stop()
    assert master.proc.returncode == 0
    _gone(pids, master)
    assert "shutdown complete" in master.text()


def test_app_under_torchrun_serves_from_rank_0(tmp_path, clip_path,
                                               one_rank_envelope):
    """``serve.app`` under ``torchrun --nproc-per-node 2``: rank 0 serves
    and reports 2 devices, rank 1 follows; the upload equals the one-rank
    envelope; SIGTERM to torchrun leaves no rank."""
    port, log = _free_port(), str(tmp_path / "torchrun.log")
    env = {k: v for k, v in os.environ.items() if k not in _ENV}
    env.update(MASTER_ENV, GUNICORN_BIND=f"127.0.0.1:{port}")
    with open(log, "w") as lf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
             "--master-port", str(_free_port()), "-m",
             "avd_tpu_torch.serve.app", "--device", "cpu"],
            env=env, cwd=REPO, stdout=lf, stderr=subprocess.STDOUT)
    m = _Master.__new__(_Master)
    m.port, m.log, m.proc = port, log, proc
    try:
        pids = m.group()
        st, ready = _get(port, "/readyz")
        assert st == 200 and ready["cuda"]["devices"] == 2
        _same(m.upload(clip_path), one_rank_envelope)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    _gone(pids, m)
