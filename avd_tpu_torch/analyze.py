"""CLI entry point: ``python -m avd_tpu_torch.analyze clip.mp4`` → response JSON.

Port of ``avd_tpu/analyze.py``: one path prints the envelope; several
paths and/or directories with ``--jsonl`` stream one
``{"path", "response"|"error"}`` object per line, the kernels built once
and reused by every clip.  ``--device`` stands for ``avd_tpu``'s platform
choice: ``cuda`` (the default; raises without a GPU) or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from avd_tpu_torch import device as device_mod
from avd_tpu_torch import pipeline

_VIDEO_EXTS = (".mp4", ".mov", ".mkv", ".avi", ".webm", ".m4v", ".wav")


def _expand(paths):
    """Yield analyzable files: given paths verbatim, directories scanned
    one level for known media extensions (sorted, deterministic)."""
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                full = os.path.join(p, name)
                if os.path.isfile(full) and \
                        name.lower().endswith(_VIDEO_EXTS):
                    yield full
        else:
            yield p


def emit_jsonl(pairs, out=None) -> int:
    """Write one ``{"path", "response"|"error"}`` JSON object per line
    for an iterable of ``(path, response_dict | Exception)`` and return
    the failure count."""
    out = out or sys.stdout
    failed = 0
    for path, res in pairs:
        if isinstance(res, BaseException):
            failed += 1
            line = {"path": path,
                    "error": f"{res.__class__.__name__}: {res}"}
        else:
            line = {"path": path, "response": res}
        json.dump(line, out)
        out.write("\n")
        out.flush()
    return failed


def _warm(device, log) -> None:
    """Build the kernels and run every window bucket once BEFORE the timed
    analyzers, so the first clip's analyzer timeout is not spent on the
    build.  On CUDA only (the CPU runs the plain versions, nothing to
    build); best-effort: analysis proceeds regardless, and a kernel that
    cannot build fails there."""
    if device.type != "cuda":
        return
    try:
        from avd_tpu_torch.ops import video_features
        video_features.warm_device(device, log=log)
    except Exception as e:
        log(f"warm-up failed ({e.__class__.__name__}: {e}); analysis "
            "proceeds without it")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="AI-video analysis on a GPU (reference-compatible JSON)")
    ap.add_argument("paths", nargs="+", metavar="path",
                    help="video/audio files (or directories) to analyze")
    ap.add_argument("--backend", choices=["jax", "oracle"], default=None,
                    help="compute backend override (env AVD_BACKEND; "
                         "'jax' is the device path, 'oracle' the host "
                         "reference loop)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the device path runs (default cuda)")
    ap.add_argument("--indent", type=int, default=None,
                    help="pretty-print the single-input envelope "
                         "(incompatible with --jsonl, which is always "
                         "compact one-object-per-line)")
    ap.add_argument("--jsonl", action="store_true",
                    help="batch mode: one {\"path\", \"response\"} JSON "
                         "object per line; analysis errors become "
                         "{\"path\", \"error\"} lines instead of aborting")
    args = ap.parse_args(argv)

    if args.backend:
        os.environ["AVD_BACKEND"] = args.backend

    files = list(_expand(args.paths))
    if not files:
        print("no analyzable files found", file=sys.stderr)
        return 2
    if len(files) > 1 and not args.jsonl:
        ap.error("multiple inputs need --jsonl")
    if args.jsonl and args.indent is not None:
        ap.error("--indent does not apply to --jsonl "
                 "(output is compact one-object-per-line)")

    device = device_mod.resolve(args.device)
    if os.getenv("AVD_BACKEND", "jax") == "jax":
        _warm(device, lambda m: print(m, file=sys.stderr, flush=True))

    if not args.jsonl:
        result = pipeline.analyze_path(files[0], device=device)
        json.dump(result, sys.stdout, indent=args.indent)
        sys.stdout.write("\n")
        return 0

    def pairs():
        for path in files:
            try:
                yield path, pipeline.analyze_path(path, device=device)
            except Exception as e:  # batch keeps going; record it
                yield path, e

    return 0 if emit_jsonl(pairs()) == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
