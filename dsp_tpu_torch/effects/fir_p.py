"""fir_p is registered by dsp_tpu_torch.effects.fir (shared UPOLS engine)."""

from dsp_tpu_torch.effects import fir as _fir  # noqa: F401
