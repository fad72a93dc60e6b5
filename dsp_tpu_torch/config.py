"""Device, dtype and stream defaults for dsp_tpu_torch.

The reference (dsp.h:42) fixes ``sample_t`` to C ``double``. Hopper has
float64 in hardware, so the port computes in float64 by default.

The sample dtype is explicit too. ``CompiledChain`` takes ``dtype``; None
reads ``DSP_TPU_TORCH_DTYPE`` (``float32``, ``float64``, ``f32`` or ``f64``,
as dsp_tpu/config.py reads ``DSP_TPU_DTYPE``) and defaults to float64 on
every device. That differs on purpose from dsp_tpu, which picks float32 on
any backend but the CPU: dsp_tpu's float32 exists because the TPU has no
usable float64, and the port's first dtype is float64. Every effect runs
in a float32 chain (``ladspa_host`` and ``watch`` are refused at init in
both dtypes).

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
DTYPE_ENV = "DSP_TPU_TORCH_DTYPE"
_DTYPES = {"float32": torch.float32, "f32": torch.float32,
           "float64": torch.float64, "f64": torch.float64}


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


def resolve_dtype(dtype=None):
    """``dtype`` (torch.float32, torch.float64, one of their names, or None)
    -> torch dtype. None reads ``DSP_TPU_TORCH_DTYPE`` and defaults to
    float64. Raises ValueError on any other value."""
    if dtype is None:
        dtype = os.environ.get(DTYPE_ENV) or DEFAULT_DTYPE
    if isinstance(dtype, str):
        if dtype.lower() not in _DTYPES:
            raise ValueError(f"unknown sample dtype {dtype!r} (float32, float64, f32 or f64)")
        return _DTYPES[dtype.lower()]
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unknown sample dtype {dtype!r} (torch.float32 or torch.float64)")
    return dtype
