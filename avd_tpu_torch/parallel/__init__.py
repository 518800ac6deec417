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
* ``pipeline`` — the GPipe schedule, forward and backward;
* ``zero`` — the data-parallel update: replicated, ZeRO-1 and FSDP, the
  global-norm clip over shards, a rank's layout of a tree;
* ``dryrun`` — the multi-rank programs (inference and training), their
  launcher and checks.

Every collective is differentiable (``collectives``: each backward is the
VJP of ``shard_map``'s transpose rules, Megatron's exit and entry for
``psum``), so the train steps over a group (``models/detector.py``'s
``make_train_step(..., sharded=True)`` and ``make_pp_train_step``) take
their gradients with autograd.
"""
