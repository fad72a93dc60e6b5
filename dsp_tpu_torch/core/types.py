"""Core stream types (reference: dsp.h:42-55)."""

from dataclasses import dataclass


@dataclass(frozen=True)
class StreamInfo:
    """Sample rate and channel count of a stream (dsp.h:49-51)."""

    fs: int
    channels: int

    def __post_init__(self):
        if self.fs <= 0:
            raise ValueError(f"invalid sample rate: {self.fs}")
        if self.channels <= 0:
            raise ValueError(f"invalid channel count: {self.channels}")

    def with_fs(self, fs):
        return StreamInfo(fs=fs, channels=self.channels)

    def with_channels(self, channels):
        return StreamInfo(fs=self.fs, channels=channels)
