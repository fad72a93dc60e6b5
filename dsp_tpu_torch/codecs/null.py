"""null codec: zero reader / bit-bucket writer (reference: null.c)."""

import numpy as np

from dsp_tpu_torch.codecs.base import (
    CODEC_HINT_NO_BUF,
    CODEC_MODE_READ,
    CODEC_MODE_WRITE,
    Codec,
    CodecInfo,
    register_codec,
)


class NullCodec(Codec):
    def __init__(self, params):
        self.path = params.path
        self.type = "null"
        self.enc = "sample_t"
        self.fs = params.fs
        self.channels = params.channels
        self.prec = 53
        self.hints = CODEC_HINT_NO_BUF
        self.buf_ratio = 1
        self.frames = -1
        self.mode = params.mode
        self._pos = 0

    def read(self, frames):
        self._pos += frames
        return np.zeros((frames, self.channels), dtype=np.float64)

    def write(self, buf):
        self._pos += len(buf)
        return len(buf)

    def seek(self, pos):
        self._pos = max(0, pos)
        return self._pos


register_codec(
    CodecInfo(
        name="null",
        modes=CODEC_MODE_READ | CODEC_MODE_WRITE,
        init=NullCodec,
        encodings=("sample_t",),
    )
)
