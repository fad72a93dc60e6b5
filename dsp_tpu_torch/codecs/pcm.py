"""pcm (raw headerless) codec (reference: pcm.c).

``pcm``/``raw``: raw interleaved samples in any supported encoding; seekable
when backed by a regular file. Reads go through Python file I/O (dsp_tpu's optional native prefetching
reader is not ported).
"""

import io
import os
import sys

import numpy as np

from dsp_tpu_torch.codecs import sampleconv
from dsp_tpu_torch.codecs.base import (
    CODEC_ENDIAN_BIG,
    CODEC_ENDIAN_LITTLE,
    CODEC_HINT_CAN_DITHER,
    CODEC_MODE_READ,
    CODEC_MODE_WRITE,
    Codec,
    CodecError,
    CodecInfo,
    register_codec,
)

_PCM_ENCODINGS = ("s16", "u8", "s8", "s24", "s24_3", "s32", "float", "double")


def _endian_char(endian, default="<"):
    if endian == CODEC_ENDIAN_BIG:
        return ">"
    if endian == CODEC_ENDIAN_LITTLE:
        return "<"
    if endian == 0:  # default
        return default
    return "<" if sys.byteorder == "little" else ">"


def _open_file(path, mode):
    if path == "-":
        return (sys.stdin.buffer if "r" in mode else sys.stdout.buffer), False
    f = open(path, mode)
    seekable = f.seekable() and os.path.isfile(path)
    return f, seekable


class PcmCodec(Codec):
    def __init__(self, params):
        enc = params.enc or "s16"
        if enc not in _PCM_ENCODINGS:
            raise CodecError(f"pcm: unsupported encoding: {enc}")
        self.path = params.path
        self.type = "pcm"
        self.enc = enc
        self.fs = params.fs
        self.channels = params.channels
        bps, prec, can_dither = sampleconv.encoding_info(enc)
        self._bps = bps
        self.prec = prec
        self.hints = CODEC_HINT_CAN_DITHER if can_dither else 0
        self.buf_ratio = params.buf_ratio
        self._endian = _endian_char(params.endian)
        self.mode = params.mode
        mode_s = "rb" if params.mode == CODEC_MODE_READ else "wb"
        self._f, self._seekable = _open_file(params.path, mode_s)
        self._frame_bytes = bps * self.channels
        if params.mode == CODEC_MODE_READ and self._seekable:
            self._f.seek(0, io.SEEK_END)
            self.frames = self._f.tell() // self._frame_bytes
            self._f.seek(0)
        else:
            self.frames = -1
        self._pos = 0

    def read(self, frames):
        data = self._f.read(frames * self._frame_bytes)
        n = len(data) // self._frame_bytes
        data = data[: n * self._frame_bytes]
        buf = sampleconv.raw_to_sample(data, self.enc, self._endian)
        self._pos += n
        return buf.reshape(n, self.channels)

    def write(self, buf):
        data = sampleconv.sample_to_raw(np.asarray(buf).reshape(-1), self.enc, self._endian)
        self._f.write(data)
        self._pos += len(buf)
        return len(buf)

    def seek(self, pos):
        # write-mode files refuse to seek, like pcm_seek's frames == -1
        # check (pcm.c:161-167); read positions always clamp (an empty
        # file previously passed a negative pos straight to f.seek)
        if not self._seekable or self.frames < 0:
            return -1
        pos = min(max(pos, 0), self.frames)
        self._f.seek(pos * self._frame_bytes)
        self._pos = pos
        return pos

    def close(self):
        if self._f not in (getattr(sys.stdin, "buffer", None), getattr(sys.stdout, "buffer", None)):
            self._f.close()


register_codec(
    CodecInfo(
        name="pcm",
        modes=CODEC_MODE_READ | CODEC_MODE_WRITE,
        extensions=("raw", "pcm"),
        init=PcmCodec,
        encodings=_PCM_ENCODINGS,
    )
)
register_codec(
    CodecInfo(
        name="raw",
        modes=CODEC_MODE_READ | CODEC_MODE_WRITE,
        init=PcmCodec,
        encodings=_PCM_ENCODINGS,
    )
)
