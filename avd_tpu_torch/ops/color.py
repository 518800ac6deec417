"""Color conversion on the device.

Port of ``avd_tpu/ops/color.py``.  ``cv2.cvtColor(BGR2GRAY)`` on uint8 is
fixed point: ``gray = (R*9798 + G*19235 + B*3735 + 16384) >> 15`` (OpenCV's
coefficients at 15-bit scale), bit-exact with cv2, with the host
runtime's ``native.bgr_to_gray`` and with ``host_prep.to_gray``.
"""

from __future__ import annotations

import torch

_R_COEF = 9798
_G_COEF = 19235
_B_COEF = 3735
_SHIFT = 15
_ROUND = 1 << (_SHIFT - 1)


def bgr_to_gray_u8(frames: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 BGR → [...] uint8 gray, bit-exact with cv2."""
    f = frames.to(torch.int32)
    acc = (f[..., 2] * _R_COEF + f[..., 1] * _G_COEF + f[..., 0] * _B_COEF
           + _ROUND)
    return (acc >> _SHIFT).to(torch.uint8)


def bgr_to_gray_f32(frames: torch.Tensor) -> torch.Tensor:
    """Same conversion, returned as float32."""
    return bgr_to_gray_u8(frames).float()
