"""tensorrt_model_optimizer_tpu_torch: the PyTorch + CUDA (Hopper) port.

Counterpart of `tensorrt_model_optimizer_tpu` (the JAX/Pallas reference),
mirroring its subpackage layout so each module names the JAX module it
reproduces. Plain JAX code becomes plain PyTorch; every Pallas kernel on a
ported path becomes a CUDA C++ kernel for `sm_90a` under `csrc/`, built with
`nvcc` at first use and bound with `ctypes` (`ops/cuda/_build.py`).

Device policy: entry points (`Engine`, `ptq.quantize`,
`hf_loader.load_hf_checkpoint`, `loader.load_quantized_checkpoint`,
`llama.init_params`) run on `cuda` unless the caller passes `device="cpu"`.
A missing card raises; nothing moves to the CPU on its own.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller says
    otherwise. Raises when CUDA is asked for and there is no card."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
