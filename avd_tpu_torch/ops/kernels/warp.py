"""Bilinear warp of the 5-plane polynomial field: CUDA kernel + plain version.

Port of ``avd_tpu/ops/pallas/warp.py:warp_bilinear``: sample src
[B, 5, H, W] at (y + dy, x + dx) for the flow planes [B, 2, H, W]; pixels
failing the OpenCV in-bounds rule (0 <= floor(coord) <= size-2) are 0.
The kernel is ``csrc/warp.cu``; ``warp_bilinear_plain`` is the same function
in plain PyTorch (a corner gather plus masks).  ``src`` may be float32 or,
under ``AVD_FLOW_BF16``, bfloat16 (as the TPU kernel takes it): each tap is
widened to float32 on load and the output is float32 either way.
"""

from __future__ import annotations

import ctypes

import torch

from avd_tpu_torch.ops.kernels import _build, _launches

LAUNCHES = 0  # kernel launches; raised only where the kernel is launched
# the same launches by the type of src
DTYPE_LAUNCHES = {"float32": 0, "bfloat16": 0}

_C = 5


def warp_bilinear_plain(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch warp with the kernel's contract (any device)."""
    B, C, H, W = src.shape
    xs = torch.arange(W, dtype=torch.float32, device=src.device)[None, None]
    ys = torch.arange(H, dtype=torch.float32, device=src.device)[None, :, None]
    fx = xs + flow[:, 0]
    fy = ys + flow[:, 1]
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    inb = (x1 >= 0) & (x1 <= W - 2) & (y1 >= 0) & (y1 <= H - 2)
    a = fx - x1
    b = fy - y1
    # out-of-bounds (and NaN) pixels gather corner 0 and are zeroed below
    base = torch.where(inb, y1 * W + x1, 0.0).to(torch.int64)
    flat = src.float().reshape(B, C, H * W)

    def corner(off: int) -> torch.Tensor:
        idx = (base + off).reshape(B, 1, H * W).expand(B, C, H * W)
        return torch.gather(flat, 2, idx).reshape(B, C, H, W)

    w00 = ((1 - b) * (1 - a))[:, None]
    w01 = ((1 - b) * a)[:, None]
    w10 = (b * (1 - a))[:, None]
    w11 = (b * a)[:, None]
    out = (w00 * corner(0) + w01 * corner(1) + w10 * corner(W)
           + w11 * corner(W + 1))
    return torch.where(inb[:, None], out, 0.0)


_SYMBOLS = {torch.float32: "avd_warp_bilinear",
            torch.bfloat16: "avd_warp_bilinear_bf16"}
_fns: dict = {}


def _bind(dtype: torch.dtype):
    fn = getattr(_build.load("warp"), _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _lib(dtype: torch.dtype):
    return _launches.symbol(_fns, dtype, lambda: _bind(dtype))


def warp_bilinear(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """[B, 5, H, W] f32 or bf16 src, [B, 2, H, W] f32 flow → [B, 5, H, W]
    f32.

    A CPU tensor takes ``warp_bilinear_plain``; a CUDA tensor launches the
    kernel or raises."""
    if src.device.type == "cpu" and flow.device.type == "cpu":
        return warp_bilinear_plain(src, flow)
    _build.check_cuda(src, "src", tuple(_SYMBOLS))
    _build.check_cuda(flow, "flow")
    B, C, H, W = src.shape
    if C != _C or tuple(flow.shape) != (B, 2, H, W):
        raise ValueError(f"shapes src {tuple(src.shape)} flow "
                         f"{tuple(flow.shape)}; want [B,5,H,W] and [B,2,H,W]")
    if flow.device != src.device:
        raise ValueError("src and flow lie on different devices")
    if H < 2 or W < 2:
        raise ValueError(f"warp needs H, W >= 2, got {H}x{W}")
    fn = _lib(src.dtype)
    out = torch.empty(src.shape, dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), flow.data_ptr(), out.data_ptr(), B, H, W,
                 torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed: cudaError {err}")
    _launches.count(globals(), "DTYPE_LAUNCHES",
                    str(src.dtype).replace("torch.", ""))
    return out
