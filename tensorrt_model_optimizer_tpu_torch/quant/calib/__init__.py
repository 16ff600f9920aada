"""Calibration algorithms (port of `quant/calib`): histogram, MSE and local
Hessian amax searches, SmoothQuant, AWQ, GPTQ and SVDQuant. None of them
reaches a Pallas kernel in the JAX package; here they are plain PyTorch
(matmuls, `torch.linalg`, elementwise ops) on the tensors' device."""

from __future__ import annotations

import numpy as np
import torch


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` as XLA computes it inside a jitted
    function, bit for bit (f32): step = i * f32(1 / (num - 1)), then
    start * (1 - step) + stop * step, and `stop` itself last. (XLA turns
    the division by the constant into a multiply by its reciprocal; the
    eager `jnp.linspace`, which divides, differs from it in a few entries.)
    Made with numpy's f32 arithmetic on the host, one rounding an op, so the
    grid is the same on every device."""
    f32 = np.float32
    div = num - 1
    if div < 1:
        return torch.full((num,), float(start), dtype=torch.float32, device=device)
    step = np.arange(div, dtype=f32) * (f32(1) / f32(div))
    grid = f32(start) * (f32(1) - step) + f32(stop) * step
    return torch.from_numpy(np.append(grid, f32(stop)).astype(f32)).to(device)
