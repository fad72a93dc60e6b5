"""pcm (raw headerless) and wavpipe codecs (reference: pcm.c).

``pcm``/``raw``: raw interleaved samples in any supported encoding; seekable
when backed by a regular file, read through the native prefetching reader
(codecs/native.py) where it is built. ``wavpipe``: write-only streaming WAV whose
header carries 0xFFFFFFFF sizes so it can be written to a pipe (pcm.c:98-142).
"""

import io
import os
import struct
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
        # native prefetching reader (dspio) when built and little-endian
        self._native = None
        if (
            params.mode == CODEC_MODE_READ
            and self._seekable
            and self._endian == "<"
            and params.path != "-"
        ):
            from dsp_tpu_torch.codecs import native

            if native.available():
                try:
                    self._native = native.NativeReader(
                        params.path, enc, self.channels, 0, self.frames
                    )
                except OSError:
                    self._native = None

    def read(self, frames):
        if self._native is not None:
            buf = self._native.read(frames)
            self._pos += len(buf)
            return buf
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
        if self._native is not None:
            self._native.seek(pos)
        else:
            self._f.seek(pos * self._frame_bytes)
        self._pos = pos
        return pos

    def close(self):
        if self._native is not None:
            self._native.close()
            self._native = None
        if self._f not in (getattr(sys.stdin, "buffer", None), getattr(sys.stdout, "buffer", None)):
            self._f.close()


_WAVPIPE_ENCODINGS = ("s16", "u8", "s24_3", "s32", "float", "double")


class WavPipeCodec(Codec):
    """Write-only streaming WAV: header sizes 0xFFFFFFFF, written once."""

    def __init__(self, params):
        if params.mode != CODEC_MODE_WRITE:
            raise CodecError("wavpipe: write only")
        enc = params.enc or "s16"
        if enc not in _WAVPIPE_ENCODINGS:
            raise CodecError(f"wavpipe: unsupported encoding: {enc}")
        self.path = params.path
        self.type = "wavpipe"
        self.enc = enc
        self.fs = params.fs
        self.channels = params.channels
        bps, prec, can_dither = sampleconv.encoding_info(enc)
        self._bps = bps
        self.prec = prec
        self.hints = CODEC_HINT_CAN_DITHER if can_dither else 0
        self.buf_ratio = params.buf_ratio
        self.frames = -1
        self._f, _ = _open_file(params.path, "wb")
        self._wrote_header = False
        self._pos = 0

    def _write_header(self):
        fmt = 3 if self.enc in ("float", "double") else 1
        block_align = self._bps * self.channels
        hdr = b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
        hdr += b"fmt " + struct.pack(
            "<IHHIIHH",
            16,
            fmt,
            self.channels,
            self.fs,
            self.fs * block_align,
            block_align,
            self._bps * 8,
        )
        hdr += b"data" + struct.pack("<I", 0xFFFFFFFF)
        self._f.write(hdr)
        self._wrote_header = True

    def write(self, buf):
        if not self._wrote_header:
            self._write_header()
        data = sampleconv.sample_to_raw(np.asarray(buf).reshape(-1), self.enc, "<")
        self._f.write(data)
        self._pos += len(buf)
        return len(buf)

    def close(self):
        if self._f is not getattr(sys.stdout, "buffer", None):
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
register_codec(
    CodecInfo(
        name="wavpipe",
        modes=CODEC_MODE_WRITE,
        init=WavPipeCodec,
        encodings=_WAVPIPE_ENCODINGS,
    )
)
