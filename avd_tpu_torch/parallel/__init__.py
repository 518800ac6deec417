"""Parallelism of the port.

Counterpart of ``avd_tpu/parallel/``.  Only the single-device
``attention.full_attention`` is ported so far; ring and Ulysses attention,
the mesh, pipeline and sharding helpers are later slices (``ROADMAP.md``).
"""
