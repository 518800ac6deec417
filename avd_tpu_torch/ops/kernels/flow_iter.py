"""One fused Farnebäck refinement round: CUDA kernel + plain version.

Port of ``avd_tpu/ops/pallas/flow_iter.py``: for the polynomial fields R0,
R1 [B, 5, H, W] and the flow [B, 2, H, W], warp R1 by the flow, form the
tapered normal-equation entries M, take their replicate-edge 15×15 box
mean and solve → the new flow [B, 2, H, W].  The kernel is
``csrc/flow_iter.cu``; the warped field and M stay on the chip.  The JAX
package's ``prepare_fields`` / ``solve_iteration_prepared`` pair padded the
operands for the TPU's memory tiling; this kernel takes the unpadded
fields, so ``solve_iteration`` is the one entry point.
``solve_iteration_plain`` composes the plain versions of the three unfused
stages and launches no kernel on any device.
"""

from __future__ import annotations

import ctypes

import torch

from avd_tpu_torch.ops.kernels import _build, _launches
from avd_tpu_torch.ops.kernels import blur_solve as blur_solve_k
from avd_tpu_torch.ops.kernels import warp as warp_k

LAUNCHES = 0  # kernel launches; raised only where the kernel is launched

_C = 5
WINSIZE = 15   # the window the kernel is compiled for (Farnebäck default)
MIN_SIZE = 16  # smallest H, W: the taper bands of two edges must not meet
# Border taper within 5 px of each edge, outermost pixel first (OpenCV
# FarnebackUpdateMatrices); handed to the kernel at each launch.
BORDER_SCALE = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


def solve_iteration_plain(R0: torch.Tensor, R1: torch.Tensor,
                          flow: torch.Tensor, winsize: int = 15
                          ) -> torch.Tensor:
    """Plain PyTorch round with the kernel's contract (any device): plain
    warp, the update arithmetic of ``ops/flow.py``, plain blur+solve."""
    from avd_tpu_torch.ops import flow as flow_ops  # imports this module
    R1w = warp_k.warp_bilinear_plain(R1, flow)
    M = flow_ops.update_from_warped(R0, R1w, flow)
    return blur_solve_k.box_blur_solve_plain(M, winsize)


_fns: dict = {}


def _bind():
    fn = _build.load("flow_iter").avd_flow_iter
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _lib():
    return _launches.symbol(_fns, "avd_flow_iter", _bind)


def solve_iteration(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                    winsize: int = 15) -> torch.Tensor:
    """R0, R1 [B, 5, H, W] f32 and flow [B, 2, H, W] f32 → the round's new
    flow [B, 2, H, W] f32.

    CPU tensors take ``solve_iteration_plain``; CUDA tensors launch the
    kernel or raise."""
    B, C, H, W = R0.shape
    if C != _C or R1.shape != R0.shape or tuple(flow.shape) != (B, 2, H, W):
        raise ValueError(f"shapes R0 {tuple(R0.shape)} R1 {tuple(R1.shape)} "
                         f"flow {tuple(flow.shape)}; want [B,5,H,W] twice "
                         "and [B,2,H,W]")
    if H < MIN_SIZE or W < MIN_SIZE:
        raise ValueError(f"the fused iteration needs H, W >= {MIN_SIZE}, "
                         f"got {H}x{W}")
    if R0.device.type == "cpu" and R1.device.type == "cpu" \
            and flow.device.type == "cpu":
        return solve_iteration_plain(R0, R1, flow, winsize)
    for name, x in (("R0", R0), ("R1", R1), ("flow", flow)):
        _build.check_cuda(x, name)
        if x.device != R0.device:
            raise ValueError("R0, R1 and flow lie on different devices")
    if winsize != WINSIZE:
        raise ValueError(f"the fused iteration kernel is built for winsize "
                         f"{WINSIZE}, got {winsize}")
    border = (ctypes.c_float * len(BORDER_SCALE))(*BORDER_SCALE)
    fn = _lib()
    out = torch.empty_like(flow)
    with torch.cuda.device(R0.device):
        err = fn(R0.data_ptr(), R1.data_ptr(), flow.data_ptr(),
                 out.data_ptr(), B, H, W, border,
                 torch.cuda.current_stream(R0.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused iteration kernel launch failed: "
                           f"cudaError {err}")
    _launches.count(globals())
    return out
