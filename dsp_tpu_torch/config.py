"""Device, dtype and stream defaults for dsp_tpu_torch.

The reference (dsp.h:42) fixes ``sample_t`` to C ``double``. Hopper has
float64 in hardware, so the port computes in float64 by default; its CUDA
kernels take float64 only.

The device is explicit. ``CompiledChain`` takes a ``torch.device``; the CLI
reads ``DSP_TPU_TORCH_DEVICE`` (default ``cuda``). Asking for CUDA where
there is none raises: nothing falls back to the CPU on its own. Tests pass
``device="cpu"`` themselves, and then every kernel wrapper runs its plain
PyTorch version.
"""

import os

import torch

# Defaults mirroring dsp.h:34-40
DEFAULT_FS = 44100
DEFAULT_CHANNELS = 1
DEFAULT_BLOCK_FRAMES = 2048
DEFAULT_INPUT_BUF_RATIO = 64
DEFAULT_OUTPUT_BUF_RATIO = 8

DEFAULT_DTYPE = torch.float64

DEVICE_ENV = "DSP_TPU_TORCH_DEVICE"


def resolve_device(device=None):
    """``device`` (str, torch.device or None) -> torch.device.

    None reads ``DSP_TPU_TORCH_DEVICE`` and defaults to ``cuda``. Raises
    RuntimeError when a CUDA device is asked for and CUDA is unavailable."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available "
            f"(set {DEVICE_ENV}=cpu to run the plain PyTorch versions on the CPU)"
        )
    return device
