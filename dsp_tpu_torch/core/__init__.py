from dsp_tpu_torch.core.types import StreamInfo

__all__ = ["StreamInfo"]
