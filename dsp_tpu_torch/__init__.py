"""dsp_tpu_torch — the dsp_tpu audio effects-chain processor on PyTorch and CUDA.

The same chain grammar, CLI and state checkpoints as ``dsp_tpu``, computed
with torch tensors on an explicit device in float64. The IIR kernels on the
main path are CUDA C++ written for Hopper (``csrc/``, built at first use by
``dsp_tpu_torch.kernels``); on a CPU tensor each kernel wrapper runs its
plain PyTorch version instead.

This package imports neither jax nor ``dsp_tpu``: the host-only modules
(grammar, chain passes, codecs) are copies, so a state or a chain string
moves between the two packages unchanged.
"""

from dsp_tpu_torch import config as config
from dsp_tpu_torch.core.types import StreamInfo

__version__ = "0.1.0"

__all__ = ["StreamInfo", "config", "__version__"]
