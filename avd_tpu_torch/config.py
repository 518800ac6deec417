"""Typed runtime configuration.

The reference configures itself with 12 bare ``os.getenv`` reads scattered
across modules (reference api.py:20-27, fusion.py:4-5,
gunicorn_conf.py:3-18).  We keep every knob — same names, same defaults, same
env-var compatibility (they are part of the operational surface) — but behind
one typed dataclass so the rest of the framework never touches the
environment directly.
"""

from __future__ import annotations

import dataclasses
import os


def _warn_bad(name: str, raw: str, default) -> None:
    """A malformed numeric knob silently running with its default hides
    operator typos (the reference fails fast at import with int('100M');
    we stay up but say so loudly)."""
    import sys
    print(f"[avd_tpu_torch.config] ignoring malformed {name}={raw!r}; "
          f"using default {default}", file=sys.stderr, flush=True)


def _env_int(name: str, default: int) -> int:
    raw = os.getenv(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        _warn_bad(name, raw, default)
        return default


def _env_float(name: str, default: float) -> float:
    raw = os.getenv(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        _warn_bad(name, raw, default)
        return default


def _env_choice(name: str, choices: tuple, default: str) -> str:
    raw = os.getenv(name)
    if raw is None:
        return default
    if raw not in choices:
        _warn_bad(name, raw, default)
        return default
    return raw


def _env_bool(name: str, default: bool) -> bool:
    return os.getenv(name, "1" if default else "0") == "1"


@dataclasses.dataclass(frozen=True)
class Config:
    """All runtime knobs. Defaults mirror the reference exactly."""

    # --- service identity (api.py:20) ---
    version: str = "1.2.3"

    # --- request limits (api.py:22-24) ---
    max_upload_bytes: int = 50 * 1024 * 1024
    resolver_max_bytes: int = 120 * 1024 * 1024
    request_timeout_s: int = 180
    # extra analyzer-timeout budget while the process hasn't executed a
    # device feature program yet: first execution pays the remote
    # Mosaic/XLA program load (minutes cold) even on a persistent-cache
    # hit.  Serving warms at boot so live requests keep the exact 180 s
    # reference behavior; this only rescues cold CLI/batch runs from
    # silently returning the neutral fallback.  0 disables.
    cold_grace_s: int = 420

    # --- feature gates (api.py:25-26) ---
    use_ytdlp: bool = True
    debug: bool = False

    # --- CORS (api.py:30) ---
    allowed_origins: str = "*"

    # --- URL resolver UA (api.py:184-185) ---
    resolver_ua: str = "Mozilla/5.0 (AVD/1.2)"

    # --- fusion thresholds (fusion.py:4-5) ---
    thresh_real_max: float = 0.35
    thresh_ai_min: float = 0.72

    # --- serving / process manager (gunicorn_conf.py:3-18) ---
    bind: str = "0.0.0.0:8000"
    workers: int = 1
    threads: int = 1
    graceful_timeout_s: int = 30
    # gunicorn_conf.py:9 — a worker whose heartbeat goes stale for this
    # long is SIGKILLed and respawned (gunicorn's hang-kill timer;
    # 0 disables).  Our worker heartbeats from a dedicated thread, so a
    # long device compile in a handler thread does NOT trip it — only a
    # wedged process does.
    worker_timeout_s: int = 180
    keepalive_s: int = 2
    max_requests: int = 200
    max_requests_jitter: int = 50
    log_level: str = "info"

    # --- TPU-native additions (not in reference) ---
    # Bucket sizes for padding frame batches to static XLA shapes.
    frame_buckets: tuple = (8, 16, 32, 64, 128, 256, 512, 1024)
    # Cross-request micro-batching window in milliseconds (0 disables).
    batch_window_ms: int = 0
    # Attach per-stage wall-time breakdown to responses when debug is set.
    profile: bool = False
    # Per-worker analysis concurrency limit (uvicorn --limit-concurrency
    # analogue): further analysis POSTs are shed with 503 + Retry-After
    # before their upload is spooled.  0 disables (reference behavior).
    max_inflight: int = 0
    # One fused warp+update+blur+solve kernel per Farnebäck solver round
    # (ops/kernels/flow_iter.py) instead of the three-stage sequence.  The
    # JAX package's name for the same switch, so a deployment's setting
    # carries over; off by default as there.
    fused_flow_iter: bool = False
    # The JAX package's switches of the heuristic video path, same names
    # and defaults.  AVD_NATIVE=0 takes the numpy plain versions of host
    # prep instead of the C++ host runtime (avd_tpu_torch/native).
    native: bool = True
    # AVD_FLOW_BF16: R0/R1 and M stored in bfloat16 between the flow
    # kernels (every sum stays float32); ignored by the fused round.
    flow_bf16: bool = False
    # AVD_PREP: "host" (320² and 32² planes made on the host) or "device"
    # (full-resolution gray shipped, resizes as matmuls on the card).
    prep_mode: str = "host"
    # AVD_CHANGE_GATE: skip the flow of pairs whose 320² planes changed by
    # less than AVD_CHANGE_GATE_THR gray levels a pixel (opt-in, diverges
    # from the reference on near-static pairs).
    change_gate: bool = False
    change_gate_thr: float = 0.5
    # AVD_FREQ_FORENSICS: attach summary["freq"] (block-DCT, blockiness,
    # noise-residual statistics).
    freq_forensics: bool = False

    @staticmethod
    def from_env() -> "Config":
        return Config(
            version=os.getenv("VERSION", "1.2.3"),
            max_upload_bytes=_env_int("MAX_UPLOAD_BYTES", 50 * 1024 * 1024),
            resolver_max_bytes=_env_int("RESOLVER_MAX_BYTES", 120 * 1024 * 1024),
            request_timeout_s=_env_int("REQUEST_TIMEOUT_S", 180),
            cold_grace_s=_env_int("AVD_COLD_GRACE_S", 420),
            use_ytdlp=_env_bool("USE_YTDLP", True),
            debug=_env_bool("DEBUG", False),
            allowed_origins=os.getenv("ALLOWED_ORIGINS", "*"),
            resolver_ua=os.getenv("RESOLVER_UA", "Mozilla/5.0 (AVD/1.2)"),
            thresh_real_max=_env_float("THRESH_REAL_MAX", 0.35),
            thresh_ai_min=_env_float("THRESH_AI_MIN", 0.72),
            bind=os.getenv("GUNICORN_BIND", "0.0.0.0:8000"),
            workers=_env_int("WEB_CONCURRENCY", 1),
            threads=_env_int("GUNICORN_THREADS", 1),
            graceful_timeout_s=_env_int("GUNICORN_GRACEFUL_TIMEOUT", 30),
            worker_timeout_s=_env_int("GUNICORN_TIMEOUT", 180),
            keepalive_s=_env_int("GUNICORN_KEEPALIVE", 2),
            max_requests=_env_int("GUNICORN_MAX_REQUESTS", 200),
            max_requests_jitter=_env_int("GUNICORN_MAX_REQUESTS_JITTER", 50),
            log_level=os.getenv("GUNICORN_LOG_LEVEL", "info"),
            batch_window_ms=_env_int("AVD_BATCH_WINDOW_MS", 0),
            profile=_env_bool("AVD_PROFILE", False),
            max_inflight=_env_int("AVD_MAX_INFLIGHT", 0),
            fused_flow_iter=_env_bool("AVD_PALLAS_ITER", False),
            native=_env_bool("AVD_NATIVE", True),
            flow_bf16=_env_bool("AVD_FLOW_BF16", False),
            prep_mode=_env_choice("AVD_PREP", ("host", "device"), "host"),
            change_gate=_env_bool("AVD_CHANGE_GATE", False),
            change_gate_thr=_env_float("AVD_CHANGE_GATE_THR", 0.5),
            freq_forensics=_env_bool("AVD_FREQ_FORENSICS", False),
        )


_CONFIG: Config | None = None


def get_config() -> Config:
    """Process-wide config, read once from the environment."""
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = Config.from_env()
    return _CONFIG


def reset_config() -> None:
    """Drop the cached config (tests mutate the environment)."""
    global _CONFIG
    _CONFIG = None
