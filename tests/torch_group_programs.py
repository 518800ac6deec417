"""The leader's side of a served rank group, for
``tests/test_torch_serve_group.py``.

    python -m tests.torch_group_programs SIZE WORKDIR

This process leads a group of SIZE gloo ranks on the CPU
(``serve/group.start``; its followers are started by it), runs the cases
below through the port's entry points on ``WORKDIR/inputs.npz``, and
writes ``WORKDIR/results.npz`` and ``results.json``.  Like the followers
it imports neither ``jax`` nor ``avd_tpu``.

* ``probs``: ``scoring.detector_timeline_resized`` of the resized frames;
* ``video``: ``analyzers.video.analyze_batch`` of the clip (the
  context-parallel pairs and the sharded detector, both group calls);
* ``features``: ``video_features.compute_features`` of the clip;
* ``threads``: 8 handler-like threads at once, each ``analyze_batch`` of
  its own clip;
* then the single-rank modes: int8 and the temporal family, scored on the
  leader alone (the group calls counted before and after, the warnings
  caught).

``served_mesh`` is a rank program for ``parallel.dryrun.launch``: a served
group's mesh over 4 ranks, whose sub-groups time out with the world.
"""

import concurrent.futures
import json
import os
import sys
import warnings

import numpy as np

SETTINGS = {"AVD_DETECTOR": "1", "AVD_DETECTOR_PRESET": "small",
            "AVD_DETECTOR_SLAB": "8", "AVD_WARMUP": "0"}
THREADS = 8


def _batch(frames):
    from avd_tpu_torch.ingest import video_reader
    n, h, w = frames.shape[:3]
    return video_reader.FrameBatch(frames, n, 8.0, w, h, n / 8.0)


def _calls(leader):
    return {k: v["n"] for k, v in leader.stats()["calls"].items()}


def main(size: int, work: str) -> None:
    os.environ.update(SETTINGS)
    import torch
    torch.set_num_threads(1)
    from avd_tpu_torch.analyzers import video as video_an
    from avd_tpu_torch.models import scoring
    from avd_tpu_torch.ops import video_features
    from avd_tpu_torch.serve import group

    with np.load(os.path.join(work, "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    leader = group.start("cpu", size)
    dev = leader.device
    out, info = {}, {"pids": leader.pids}
    try:
        out["probs"] = np.asarray(scoring.detector_timeline_resized(
            inputs["resized"], dev)["timeline"])
        info["video"] = video_an.analyze_batch(_batch(inputs["clip"]),
                                               device=dev)
        feats = video_features.compute_features(inputs["clip"], dev)
        for k in ("flow_means", "flow_vars", "textures", "timeline_ai"):
            out[f"features/{k}"] = np.asarray(feats[k])
        info["features_dup"] = feats["dup"]
        clips = [inputs[f"clip_{i}"] for i in range(THREADS)]
        with concurrent.futures.ThreadPoolExecutor(THREADS) as pool:
            info["threads"] = list(pool.map(
                lambda c: video_an.analyze_batch(_batch(c), device=dev),
                clips))
        info["stats"] = leader.stats()
        for mode, env in (("int8", {"AVD_DETECTOR_QUANT": "1"}),
                          ("temporal", {"AVD_DETECTOR_ARCH": "temporal"})):
            before = _calls(leader)
            os.environ.update(env)
            scoring._bundle.cache_clear()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                det = scoring.detector_timeline(inputs["clip"], dev)
            for k in env:
                del os.environ[k]
            out[f"single/{mode}"] = np.asarray(det["timeline"])
            info[f"single/{mode}"] = {
                "weights": det["weights"],
                "warnings": [str(w.message) for w in caught],
                "group_calls": [before, _calls(leader)]}
    finally:
        leader.stop()
    np.savez(os.path.join(work, "results.npz"), **out)
    with open(os.path.join(work, "results.json"), "w") as f:
        json.dump(info, f)


def served_mesh(ctx, opts):
    """A served group's (data, model) mesh over 4 ranks: rank
    ``opts["rank"]`` reaches its "model" sub-group's all-reduce
    ``opts["late_s"]`` late, past the group's collective timeout; each
    rank's seconds in the all-reduce and whether it raised."""
    import time

    import torch
    import torch.distributed as dist

    from avd_tpu_torch.parallel import distributed
    from avd_tpu_torch.parallel import mesh as mesh_mod
    distributed._SERVED = True
    try:
        mesh = mesh_mod.make_mesh(None, ("data", "model"))
        if ctx.rank == opts["rank"]:
            time.sleep(opts["late_s"])
        t0, raised = time.monotonic(), False
        try:
            dist.all_reduce(torch.ones(1), group=mesh.get_group("model"))
        except RuntimeError:
            raised = True
        return {"info": {"s": time.monotonic() - t0, "raised": raised,
                         "shape": mesh_mod.mesh_shape(mesh)}}
    finally:
        distributed._SERVED = False


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])
