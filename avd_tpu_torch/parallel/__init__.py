"""Parallelism of the port: inference over a rank group.

Counterpart of ``avd_tpu/parallel/``, on ``torch.distributed`` with one
process per rank (``distributed.initialize``) where ``avd_tpu`` has one
controller and ``shard_map``/GSPMD:

* ``collectives`` — the ``lax`` primitives on named mesh dims, the only
  caller of ``torch.distributed``'s collectives (NCCL, gloo, or gloo
  staged through host memory for CUDA tensors);
* ``mesh`` — ``DeviceMesh`` construction and parameter sharding by spec;
* ``distributed`` — joining the group, ``cp_mesh``;
* ``halo`` — the video path's time axis with a one-frame halo;
* ``attention`` — full, ring and Ulysses attention;
* ``pipeline`` — the GPipe forward;
* ``dryrun`` — the multi-rank programs, their launcher and checks.

Training over a group (ZeRO-1, FSDP, the dp × tp step, GPipe's backward,
sharded checkpoints) is the next slice (``ROADMAP.md``).
"""
