"""Benchmark of the PyTorch/CUDA port (``avd_tpu_torch``) on one card.

One run measures one cell of the root ``BENCHMARK.json``:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``
(whose ``kind`` names the driver in ``drivers/<kind>.py``), each per-layer
metric's reader in ``metrics/<metric>.py`` and each kernel's or model's
operation and byte count in ``roofline/``.  The plain reference that
decides ``correct`` lives in ``reference/`` and imports nothing of the
program.  Nothing here imports ``jax`` or the JAX package ``avd_tpu``.
"""
