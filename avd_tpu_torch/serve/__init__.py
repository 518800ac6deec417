"""HTTP serving: micro-framework, routes, pre-fork master, batching queue.

Port of ``avd_tpu/serve``.  The reference serves FastAPI under
Gunicorn/UvicornWorker (its api.py, gunicorn_conf.py).  This package
reproduces the full HTTP surface — 8 routes, CORS, multipart streaming,
error mapping with the reference's Italian messages — on the Python
stdlib, plus a pre-fork worker master with max-requests recycling
equivalent to the reference's Gunicorn config.  Only the routes'
analysis, the worker warm-up and the cross-request window batcher touch
the GPU; the master process never imports ``torch``.
"""
