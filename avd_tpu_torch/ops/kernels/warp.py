"""Bilinear warp of the 5-plane polynomial field: CUDA kernel + plain version.

Port of ``avd_tpu/ops/pallas/warp.py:warp_bilinear``: sample src
[B, 5, H, W] at (y + dy, x + dx) for the flow planes [B, 2, H, W]; pixels
failing the OpenCV in-bounds rule (0 <= floor(coord) <= size-2) are 0.
The kernel is ``csrc/warp.cu``; ``warp_bilinear_plain`` is the same function
in plain PyTorch (a corner gather plus masks).  ``src`` may be float32 or,
under ``AVD_FLOW_BF16``, bfloat16 (as the TPU kernel takes it): each tap is
widened to float32 on load and the output is float32 either way.

``warp_update`` is a solver round's warp with the round's pointwise update
as its epilogue: the same kernel's update instance writes the
normal-equation entries M of ``ops/flow.py:update_from_warped`` in place
of the warped field, bit for bit the plain composition
``warp_update_plain``.  Each of its launches is a warp launch too
(``LAUNCHES``, ``DTYPE_LAUNCHES``); ``VARIANT_LAUNCHES`` tells the two
instances apart.
"""

from __future__ import annotations

import ctypes

import torch

from avd_tpu_torch.ops.kernels import _build, _launches

LAUNCHES = 0  # kernel launches; raised only where the kernel is launched
# the same launches by the type of src
DTYPE_LAUNCHES = {"float32": 0, "bfloat16": 0}
# the same launches by instance: the plain warp, or with the update epilogue
VARIANT_LAUNCHES = {"warp": 0, "update": 0}

_C = 5
# Border taper within 5 px of each edge, outermost pixel first (OpenCV
# FarnebackUpdateMatrices); handed to the update instance at each launch.
BORDER_SCALE = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


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


def warp_update_plain(R0: torch.Tensor, R1: torch.Tensor,
                      flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch warp + update with the update instance's contract (any
    device): ``update_from_warped(R0, warp_bilinear_plain(R1, flow),
    flow)``."""
    from avd_tpu_torch.ops import flow as flow_ops  # imports this module
    return flow_ops.update_from_warped(R0, warp_bilinear_plain(R1, flow),
                                       flow)


_SYMBOLS = {torch.float32: "avd_warp_bilinear",
            torch.bfloat16: "avd_warp_bilinear_bf16"}
_UPDATE_SYMBOLS = {torch.float32: "avd_warp_update",
                   torch.bfloat16: "avd_warp_update_bf16"}
# by instance: the pointers, B, H, W (the update: and the taper), the stream
_ARGTYPES = {
    "warp": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "update": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]}
_fns: dict = {}


def _bind(dtype: torch.dtype, variant: str):
    symbols = _UPDATE_SYMBOLS if variant == "update" else _SYMBOLS
    fn = getattr(_build.load("warp"), symbols[dtype])
    fn.argtypes = _ARGTYPES[variant]
    fn.restype = ctypes.c_int
    return fn


def _lib(dtype: torch.dtype, variant: str = "warp"):
    return _launches.symbol(_fns, (variant, dtype),
                            lambda: _bind(dtype, variant))


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
                    str(src.dtype).replace("torch.", ""),
                    "VARIANT_LAUNCHES", "warp")
    return out


def warp_update(R0: torch.Tensor, R1: torch.Tensor,
                flow: torch.Tensor) -> torch.Tensor:
    """R0, R1 [B, 5, H, W] (both f32 or both bf16) and flow [B, 2, H, W] f32
    → the round's normal-equation entries M [B, 5, H, W] f32.

    CPU tensors take ``warp_update_plain``; CUDA tensors launch the warp
    kernel's update instance or raise."""
    if R0.device.type == "cpu" and R1.device.type == "cpu" \
            and flow.device.type == "cpu":
        return warp_update_plain(R0, R1, flow)
    _build.check_cuda(R0, "R0", tuple(_UPDATE_SYMBOLS))
    _build.check_cuda(R1, "R1", tuple(_UPDATE_SYMBOLS))
    _build.check_cuda(flow, "flow")
    if not R0.device == R1.device == flow.device:
        raise ValueError("R0, R1 and flow lie on different devices")
    if R0.dtype != R1.dtype:
        raise TypeError(f"R0 and R1 must share a type, not {R0.dtype} and "
                        f"{R1.dtype}")
    B, C, H, W = R1.shape
    if C != _C or R0.shape != R1.shape or tuple(flow.shape) != (B, 2, H, W):
        raise ValueError(f"shapes R0 {tuple(R0.shape)} R1 {tuple(R1.shape)} "
                         f"flow {tuple(flow.shape)}; want [B,5,H,W] twice "
                         "and [B,2,H,W]")
    if H < 2 or W < 2:
        raise ValueError(f"warp needs H, W >= 2, got {H}x{W}")
    border = (ctypes.c_float * len(BORDER_SCALE))(*BORDER_SCALE)
    fn = _lib(R1.dtype, "update")
    out = torch.empty(R1.shape, dtype=torch.float32, device=R1.device)
    with torch.cuda.device(R1.device):
        err = fn(R0.data_ptr(), R1.data_ptr(), flow.data_ptr(),
                 out.data_ptr(), B, H, W, border,
                 torch.cuda.current_stream(R1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp kernel (update) launch failed: "
                           f"cudaError {err}")
    _launches.count(globals(), "DTYPE_LAUNCHES",
                    str(R1.dtype).replace("torch.", ""),
                    "VARIANT_LAUNCHES", "update")
    return out
