"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device (launch the
    kernel), False when every tensor lies on the CPU (the plain
    version). Anything else raises: a wrapper never moves data."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel arguments span devices {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device type {kind!r}")


def kernel_arg(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> int:
    """Check one kernel argument and return its device pointer. The
    kernels read and write 16-byte vectors, so every array must be
    contiguous and 16-byte aligned."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
    return t.data_ptr()


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
