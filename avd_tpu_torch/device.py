"""Device resolution for the port's entry points.

``resolve(None)`` means ``torch.device("cuda")``.  When CUDA is absent it
raises instead of running on the CPU: a CPU run happens only when the
caller asks for it (``device="cpu"``), as the tests do.  Resolving also
pins float32 matmuls and convolutions to full precision — the band and
resize products (``ops/band.py``) need true fp32, and PyTorch's cuDNN
default is TF32.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def pinned(device=None) -> torch.device:
    """``resolve(device)`` with its index: threads that run work for a
    caller (the analyzers, the window batcher) must not depend on their
    own current device."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
