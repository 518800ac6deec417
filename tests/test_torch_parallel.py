"""The port's parallel layer on rank groups (CPU, gloo) against ``avd_tpu``.

Ranks are processes spawned by ``avd_tpu_torch.parallel.dryrun.launch``
with a ``FileStore`` rendezvous in ``tmp_path`` and a timeout on every
collective; they import neither ``jax`` nor ``avd_tpu``.  The JAX side runs
here, on the suite's 8-device virtual CPU mesh.  Held, at ``avd_tpu``'s
own tolerances:

* the one-frame-halo ``cp_frame_deltas`` at 2, 3 and 4 ranks against
  numpy (rtol 1e-5, ``tests/test_parallel.py:31-50``);
* ``compute_features`` in a group (its context-parallel branch) and with
  ``AVD_CP=0`` against the single-device port (flow means and variances
  rtol 1e-5 / atol 1e-6, timeline atol 1e-6, ``dup`` equal;
  ``:139-161``) and against ``avd_tpu``'s CP result at the port's flow
  contract with ``avd_tpu`` (means rtol 1e-4, variances 1e-3, timeline
  1e-4, ``dup`` equal); ``cp_mesh``'s gating;
* ring and Ulysses attention against ``full_attention`` and against
  ``avd_tpu``'s sharded output (1e-5, bf16 2e-2;
  ``tests/test_attention_parallel.py``);
* each collective's semantics and its counts by kind and transport, the
  mesh shape rule, the transport rule, and a failing or hanging rank
  failing the launch.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from avd_tpu.ops import video_features as jvf
from avd_tpu.parallel import attention as jatt
from avd_tpu.parallel import mesh as jmesh
from avd_tpu_torch.ops import video_features as tvf
from avd_tpu_torch.parallel import attention as tatt
from avd_tpu_torch.parallel import collectives, distributed, dryrun
from avd_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

RANKS = "tests.torch_rank_programs:"
CP_FRAMES = (19, 96, 128, 3)


def _clips(n):
    """tests/test_parallel.py's clips: 8 frames a rank, and 32 frames of
    6x6 where they divide."""
    out = {f"clip{n}": np.random.default_rng(n).random(
        (8 * n, 4, 4)).astype(np.float32)}
    if 32 % n == 0:
        out["clip32"] = np.random.default_rng(0).random(
            (32, 6, 6)).astype(np.float32)
    return out


def _qkv(dtype, B=2, H=4, T=32, D=16):
    rng = np.random.default_rng(0)
    return [np.asarray(jnp.asarray(rng.standard_normal((B, H, T, D)),
                                   dtype), np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def cp_frames():
    return np.random.default_rng(3).integers(0, 255, CP_FRAMES) \
        .astype(np.uint8)


@pytest.fixture(scope="module")
def launches(tmp_path_factory, cp_frames):
    """One launch per world size (and one under AVD_CP=0), every check's
    program in it: {world: [rank reports]}."""
    work = str(tmp_path_factory.mktemp("ranks"))
    qkv = {f"{x}_{dt}": a for dt, jdt in (("f32", jnp.float32),
                                          ("bf16", jnp.bfloat16))
           for x, a in zip("qkv", _qkv(jdt))}
    out = {}
    for n in (2, 3, 4):
        progs = [{"name": "deltas", "kind": RANKS + "frame_deltas"},
                 {"name": "col", "kind": RANKS + "collectives"}]
        if n != 3:
            progs += [{"name": "cp", "kind": "cp_compute"},
                      {"name": "attn", "kind": RANKS + "attention"},
                      {"name": "mesh", "kind": RANKS + "mesh_rules"}]
        out[n] = dryrun.launch(
            n, "cpu", progs, inputs={**_clips(n), **qkv,
                                     "cp_bgr": cp_frames},
            spec=dryrun.small_spec(), timeout_s=240, workdir=work)
    out["cp0"] = dryrun.launch(
        2, "cpu", [{"name": "cp", "kind": "cp_compute"},
                   {"name": "mesh", "kind": RANKS + "mesh_rules"}],
        inputs={"cp_bgr": cp_frames}, spec=dryrun.small_spec(),
        env={"AVD_CP": "0"}, timeout_s=240, workdir=work)
    return out


def _prog(ranks, name):
    return [r["programs"][name] for r in ranks]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_cp_frame_deltas_match_numpy(launches, n):
    for rep in _prog(launches[n], "deltas"):
        for key, clip in _clips(n).items():
            feats = rep["outputs"][f"{key}_feats"]
            valid = rep["outputs"][f"{key}_valid"]
            assert valid.dtype == np.bool_ and valid.sum() == len(clip) - 1
            assert not valid[-1]
            ref = np.abs(np.diff(clip, axis=0)).mean(axis=(1, 2))
            np.testing.assert_allclose(feats[valid], ref, rtol=1e-5)
        assert rep["collectives"]["ppermute/gloo"] == len(_clips(n))
        assert rep["collectives"]["staged"] == 0


@pytest.fixture(scope="module")
def cp_refs(cp_frames):
    """(port on one device, avd_tpu's CP result on its 8-device mesh)."""
    single = tvf.compute_features(cp_frames, device="cpu")
    old = os.environ.get("AVD_CP")
    os.environ["AVD_CP"] = "1"
    try:
        jcp = jvf.compute_features(cp_frames)
    finally:
        if old is None:
            os.environ.pop("AVD_CP")
        else:
            os.environ["AVD_CP"] = old
    return single, jcp


def _same_features(got, ref, mean_rtol=1e-5, var_rtol=1e-5,
                   timeline_atol=1e-6):
    assert int(got["total"]) == ref["total"] == CP_FRAMES[0]
    assert int(got["dup"]) == ref["dup"]
    np.testing.assert_allclose(got["flow_means"], ref["flow_means"],
                               rtol=mean_rtol, atol=1e-6)
    np.testing.assert_allclose(got["flow_vars"], ref["flow_vars"],
                               rtol=var_rtol, atol=1e-6)
    np.testing.assert_allclose(got["timeline_ai"], ref["timeline_ai"],
                               atol=timeline_atol)


@pytest.mark.parametrize("n", [2, 4, "cp0"])
def test_cp_compute_features_matches_single_device_and_avd_tpu(
        launches, cp_refs, n):
    single, jcp = cp_refs
    for rep in _prog(launches[n], "cp"):
        _same_features(rep["outputs"], single)
        # across the packages the flow holds its own contract (per-pair
        # mean rtol 1e-4, variance 1e-3, timeline 1e-4:
        # tests/test_torch_video_features.py, ROADMAP.md): the port's
        # single-device flow already differs from avd_tpu's by 2.7e-5
        # relative on this clip's variances, so 1e-5 cannot hold there
        _same_features(rep["outputs"], jcp, mean_rtol=1e-4, var_rtol=1e-3,
                       timeline_atol=1e-4)
        # the halo path ran (two ppermutes and one all_gather a call), or
        # under AVD_CP=0 no collective at all
        want = {} if n == "cp0" else {"ppermute/gloo": 2, "all_gather/gloo": 1}
        got = {k: v for k, v in rep["collectives"].items()
               if k not in ("staged", "barrier/gloo")}
        assert got == want


def test_cp_mesh_gating(launches, monkeypatch):
    monkeypatch.setenv("AVD_CP", "1")
    assert distributed.cp_mesh() is None  # one process: no group
    for rep in _prog(launches[4], "mesh"):
        assert rep["info"]["cp_mesh"] == {"time": 4}
    for rep in _prog(launches["cp0"], "mesh"):
        assert rep["info"]["cp_mesh"] is None


def test_make_mesh_shape_rule(launches):
    for n in (2, 4):
        for rep in _prog(launches[n], "mesh"):
            info = rep["info"]
            d, m = tmesh.factor2(n)
            assert info["data/model"] == {"data": d, "model": m}
            assert info["time"] == {"time": n}
            assert info["data/stage/model"] == {"data": n, "stage": 1,
                                                "model": 1}
            assert "requested" in info["errors"][0]
            assert "does not hold" in info["errors"][1]


def test_factor2_matches_avd_tpu():
    for n in range(1, 17):
        assert tmesh.factor2(n) == jmesh.factor2(n)


@pytest.fixture(scope="module")
def attn_refs():
    """full_attention and avd_tpu's ring/Ulysses over 4 and 2 of its
    virtual devices, per dtype."""
    out = {}
    for dt, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        q, k, v = (jnp.asarray(a, jdt) for a in _qkv(jdt))
        out[f"full_{dt}"] = np.asarray(jatt.full_attention(q, k, v),
                                       np.float32)
        spec = JP(None, None, "seq", None)
        for s in (2, 4):
            mesh = jmesh.make_mesh(s, axes=("seq",))
            for name, fn in (
                    ("ring", lambda a, b, c: jatt.ring_attention(
                        a, b, c, "seq", s)),
                    ("ulysses", lambda a, b, c: jatt.ulysses_attention(
                        a, b, c, "seq"))):
                run = jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                                    out_specs=spec)
                with mesh:
                    out[f"{name}_{dt}_{s}"] = np.asarray(
                        jax.jit(run)(q, k, v), np.float32)
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention(launches, attn_refs, n, impl):
    q, k, v = (torch.from_numpy(np.array(a)) for a in _qkv(jnp.float32))
    full = tatt.full_attention(q, k, v).numpy()
    np.testing.assert_allclose(full, attn_refs["full_f32"], atol=1e-5,
                               rtol=1e-5)
    for rep in _prog(launches[n], "attn"):
        out = rep["outputs"]
        np.testing.assert_allclose(out[f"{impl}_f32"], full, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(out[f"{impl}_f32"],
                                   attn_refs[f"{impl}_f32_{n}"], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(out[f"{impl}_bf16"],
                                   attn_refs["full_bf16"], atol=2e-2)
        np.testing.assert_allclose(out[f"{impl}_bf16"],
                                   attn_refs[f"{impl}_bf16_{n}"], atol=2e-2)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_collectives_semantics_and_counts(launches, n):
    for r, rep in enumerate(_prog(launches[n], "col")):
        out = rep["outputs"]
        x = lambda i: np.arange(4, dtype=np.float32) + 10 * i  # noqa: E731
        np.testing.assert_array_equal(out["ppermute"], x((r - 1) % n))
        np.testing.assert_array_equal(
            out["ppermute_partial"], x(0) if r == 1 else np.zeros(4))
        total = sum(x(i) for i in range(n))
        np.testing.assert_array_equal(out["psum"], total)
        np.testing.assert_array_equal(out["psum_bf16"], total)
        np.testing.assert_array_equal(
            out["all_gather"],
            np.concatenate([x(i).reshape(2, 2) for i in range(n)], axis=1))
        scat = sum(np.arange(2 * n, dtype=np.float32) * (i + 1)
                   for i in range(n))
        np.testing.assert_array_equal(out["psum_scatter"],
                                      scat[2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            out["all_to_all"].reshape(-1),
            np.concatenate([np.arange(3 * r, 3 * r + 3, dtype=np.float32)
                            + 100 * i for i in range(n)]))
        assert rep["info"] == {"all_gather/gloo": 1, "all_to_all/gloo": 1,
                               "ppermute/gloo": 2, "psum/gloo": 2,
                               "psum_scatter/gloo": 1, "staged": 0}


def test_transport_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert collectives.transport("gloo", cpu) == "gloo"
    assert collectives.transport("gloo", cuda) == "gloo-staged"
    assert collectives.transport("nccl", cuda) == "nccl"
    with pytest.raises(ValueError, match="CUDA tensors only"):
        collectives.transport("nccl", cpu)
    with pytest.raises(ValueError, match="unsupported backend"):
        collectives.transport("mpi", cpu)


def test_local_slice_cuts_by_coordinates():
    x = torch.arange(24.).reshape(4, 6)
    sizes = {"data": 2, "model": 3}
    blocks = [[tmesh.local_slice(x, tmesh.P("data", "model"),
                                 {"data": i, "model": j}.get, sizes.get)
               for j in range(3)] for i in range(2)]
    assert torch.equal(torch.cat([torch.cat(row, 1) for row in blocks]), x)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.local_slice(x, tmesh.P(None, "data"), {"data": 0}.get,
                          {"data": 4}.get)
    with pytest.raises(ValueError, match="one axis name"):
        tmesh.local_slice(x, (("data", "model"),), {}.get, {}.get)


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_mesh(None, ("time",))


def test_failing_rank_fails_the_launch(tmp_path):
    with pytest.raises(dryrun.RankFailed) as err:
        dryrun.launch(2, "cpu", [{"name": "f", "kind": RANKS + "fail_on_rank",
                                  "rank": 1}], spec=dryrun.small_spec(),
                      timeout_s=120, collective_timeout_s=30,
                      workdir=str(tmp_path))
    # rank 1's traceback is there, whether or not rank 0 also fell over
    # when its peer went away
    msg = str(err.value)
    assert "rank 1 of 2 failed (exit 1)" in msg
    assert "ValueError: rank 1 fails on purpose" in msg


def test_hanging_rank_times_out(tmp_path):
    # rank 0 may not have finished either on a loaded host; rank 1 never
    with pytest.raises(dryrun.RankFailed,
                       match=r"ranks \[(0, )?1\] of 2 still running"):
        dryrun.launch(2, "cpu", [{"name": "s", "kind": RANKS + "sleep_on_rank",
                                  "rank": 1}], spec=dryrun.small_spec(),
                      timeout_s=6, workdir=str(tmp_path))
