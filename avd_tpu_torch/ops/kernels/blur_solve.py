"""Fused 15×15 box blur + 2×2 solve: CUDA kernel + plain version.

Port of ``avd_tpu/ops/pallas/blur_solve.py:box_blur_solve``: the
replicate-edge box mean of M = (g11, g12, g22, h1, h2) [B, 5, H, W], then
idet = 1/(g11·g22 − g12² + 1e-3) and the per-pixel solve → [B, 2, H, W].
The kernel is ``csrc/blur_solve.cu``; ``box_blur_solve_plain`` is the same
function in plain PyTorch (replicate pad, separable shifted sums in the
kernel's order, solve) with no convolution library call.  ``M`` may be
float32 or, under ``AVD_FLOW_BF16``, bfloat16 (as the TPU kernel takes
it): it is widened to float32 before the sums, and the flow is float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from avd_tpu_torch.ops.kernels import _build, _launches

LAUNCHES = 0  # kernel launches; raised only where the kernel is launched
# the same launches by the type of M
DTYPE_LAUNCHES = {"float32": 0, "bfloat16": 0}

_C = 5
WINSIZE = 15  # the window the kernel is compiled for (Farnebäck default)


def solve_flow(mblur: torch.Tensor) -> torch.Tensor:
    """Regularized per-pixel 2×2 solve on [B,5,H,W] → [B,2,H,W] flow."""
    g11, g12, g22, h1, h2 = mblur.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g22 * h1 - g12 * h2) * idet,
                        (g11 * h2 - g12 * h1) * idet], dim=1)


def box_blur_mean(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """Replicate-edge box mean over [B,C,H,W]: horizontal sums, then
    vertical sums, each left to right from 0, then × 1/winsize²."""
    B, C, H, W = m.shape
    half = (winsize - 1) // 2
    p = F.pad(m.float().reshape(B * C, 1, H, W), (half, half, half, half),
              mode="replicate").reshape(B, C, H + 2 * half, W + 2 * half)
    hs = p[..., 0:W]
    for k in range(1, winsize):
        hs = hs + p[..., k:k + W]
    vs = hs[..., 0:H, :]
    for j in range(1, winsize):
        vs = vs + hs[..., j:j + H, :]
    return vs * (1.0 / (winsize * winsize))


def box_blur_solve_plain(m: torch.Tensor, winsize: int = 15) -> torch.Tensor:
    """Plain PyTorch blur+solve with the kernel's contract (any device)."""
    return solve_flow(box_blur_mean(m, winsize))


_SYMBOLS = {torch.float32: "avd_blur_solve",
            torch.bfloat16: "avd_blur_solve_bf16"}
_fns: dict = {}


def _bind(dtype: torch.dtype):
    fn = getattr(_build.load("blur_solve"), _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _lib(dtype: torch.dtype):
    return _launches.symbol(_fns, dtype, lambda: _bind(dtype))


def box_blur_solve(m: torch.Tensor, winsize: int = 15) -> torch.Tensor:
    """[B, 5, H, W] f32 or bf16 M field → [B, 2, H, W] f32 flow planes.

    A CPU tensor takes ``box_blur_solve_plain``; a CUDA tensor launches the
    kernel or raises.  The bf16 kernel holds the plain version to the TPU
    kernel's tolerance where M is finite; a non-finite value of bf16 M
    makes outputs non-finite up to 23 columns and 11 rows from it, beyond
    its 15×15 window (``csrc/blur_solve.cu`` says why)."""
    if m.device.type == "cpu":
        return box_blur_solve_plain(m, winsize)
    _build.check_cuda(m, "M", tuple(_SYMBOLS))
    B, C, H, W = m.shape
    if C != _C:
        raise ValueError(f"M shape {tuple(m.shape)}; want [B,5,H,W]")
    if winsize != WINSIZE:
        raise ValueError(f"the blur+solve kernel is built for winsize "
                         f"{WINSIZE}, got {winsize}")
    fn = _lib(m.dtype)
    out = torch.empty((B, 2, H, W), dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        err = fn(m.data_ptr(), out.data_ptr(), B, H, W,
                 torch.cuda.current_stream(m.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blur+solve kernel launch failed: cudaError {err}")
    _launches.count(globals(), "DTYPE_LAUNCHES",
                    str(m.dtype).replace("torch.", ""))
    return out
