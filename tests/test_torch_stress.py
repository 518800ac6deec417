"""Serving concurrency stress on the port's app: the cases of
``tests/test_stress.py`` against ``avd_tpu_torch.serve`` (``device="cpu"``,
the host path).  24 concurrent clients mix uploads, health checks and bad
requests through the window batcher; every response is well formed, no
request sees another's result, and ``/metrics`` stays consistent after."""

import concurrent.futures
import json
import threading

import pytest

from avd_tpu_torch import config as config_mod
from avd_tpu_torch.serve import app as app_mod
from avd_tpu_torch.serve import batching
from avd_tpu_torch.serve import http as http_mod
from tests import fixtures
from tests.test_torch_serve import _multipart, _request


@pytest.fixture(scope="module")
def stress_server():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVD_BACKEND", "oracle")
        mp.setenv("AVD_BATCH_WINDOW_MS", "20")
        config_mod.reset_config()
        batching.reset_active()
        srv = http_mod.make_server(app_mod.build_app(device="cpu"),
                                   "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        yield srv.server_address[1]
        srv.shutdown()
    config_mod.reset_config()
    batching.reset_active()


def test_concurrent_mixed_traffic(stress_server, tmp_path):
    """24 concurrent clients mixing uploads, health checks, bad requests:
    every response well formed, no cross-request bleed."""
    port = stress_server
    clip_a = fixtures.write_video(str(tmp_path / "a.mp4"),
                                  fixtures.solid_clip(30, 64), fps=30.0)
    clip_b = fixtures.write_video(str(tmp_path / "b.mp4"),
                                  fixtures.noise_clip(30, 64), fps=30.0)
    with open(clip_a, "rb") as f:
        payload_a = f.read()
    with open(clip_b, "rb") as f:
        payload_b = f.read()

    def upload(payload):
        body, headers = _multipart(files={"file": ("c.mp4", payload)})
        status, _, data = _request(port, "POST", "/analyze", body, headers)
        assert status == 200
        d = json.loads(data)
        assert d["ok"] is True
        return d["video"]["summary"].get("dup_density")

    def health():
        status, _, _ = _request(port, "GET", "/healthz")
        assert status == 200

    def bad():
        status, _, _ = _request(port, "POST", "/analyze", b"junk",
                                {"Content-Type": "text/plain",
                                 "Content-Length": "4"})
        assert status == 422

    jobs = []
    for _ in range(8):
        jobs += [("a", upload, payload_a), ("b", upload, payload_b),
                 ("h", health, None), ("x", bad, None)]
    results = {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=24) as pool:
        futs = {(pool.submit(fn, arg) if arg is not None
                 else pool.submit(fn)): (idx, tag)
                for idx, (tag, fn, arg) in enumerate(jobs)}
        for fut, key in futs.items():
            results[key] = fut.result(timeout=180)

    # solid clips always report full duplication, noise clips none: any
    # mixing across requests would break these invariants
    dups_a = [v for (_, t), v in results.items() if t == "a"]
    dups_b = [v for (_, t), v in results.items() if t == "b"]
    assert len(dups_a) == len(dups_b) == 8
    assert all(v == 1.0 for v in dups_a), dups_a
    assert all(v == 0.0 for v in dups_b), dups_b


def test_metrics_consistent_after_stress(stress_server):
    """After the mixed traffic, ``/metrics`` answers in JSON and in
    Prometheus text with the same counters, none negative."""
    status, _, data = _request(stress_server, "GET", "/metrics")
    assert status == 200
    m = json.loads(data)["metrics"]
    nums = {k: v for k, v in m.items() if isinstance(v, (int, float))}
    assert all(v >= 0 for v in nums.values()), nums
    status, headers, text = _request(stress_server, "GET",
                                     "/metrics?format=prometheus")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    names = {line.split()[0] for line in text.decode().splitlines()
             if line and not line.startswith("#")}
    assert names == {"avd_" + k for k in nums}, (names, sorted(nums))
