"""avd_tpu_torch — the PyTorch/CUDA port of ``avd_tpu``.

Takes a media file to the reference-compatible JSON envelope on an NVIDIA
H100 (``pipeline.analyze_path``, ``python -m avd_tpu_torch.analyze``):
probe and decode (``ingest/``, the libav* feeder in ``native/``), the
video-feature path (host prep, average-hash duplicates, batched Farnebäck
flow with hand-written CUDA warp, blur+solve and fused-round kernels), the
per-frame ViT detector on the shipped weights (``models/``, with a
hand-written attention kernel), the audio window features, fusion and the
forensic block.  The package imports ``torch`` and
never ``jax`` or anything of ``avd_tpu``: every framework-free helper it
needs is its own copy.  Module paths mirror ``avd_tpu`` so each
counterpart is easy to find.

Entry points take ``device=``; the default is ``torch.device("cuda")``, and
they raise when CUDA is absent unless the caller asks for the CPU
(``avd_tpu_torch.device.resolve``).
"""

__version__ = "1.2.3"
