"""mp3 codec: read-only MP3 decode via libmad (reference:
mp3.c).

The decoder lives in a small C shim (native/dspmad.c, built with
``make -C native mad`` where mad.h is available) bound with ctypes — the
same structure as the ffmpeg codec's dspav shim. Registration is gated on
the shim's presence, mirroring the reference's HAVE_MAD configure gating
(configure:46 — disabled by default there too); without it, ``.mp3`` files
still decode through the ffmpeg codec's extension/fallback dispatch
(codec.c:200-231 fallback order).

Codec surface matches mp3.c:188-252: read-only, enc "mad_f", prec 24,
frame count from a header pre-scan, seek lands on a frame boundary at or
past the target.
"""

import ctypes
import os

import numpy as np

from dsp_tpu_torch.codecs.base import (
    CODEC_MODE_READ,
    Codec,
    CodecError,
    CodecInfo,
    register_codec,
)

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib

    def _declare(lib):
        lib.dspmad_open.restype = ctypes.c_void_p
        lib.dspmad_open.argtypes = [ctypes.c_char_p]
        lib.dspmad_sample_rate.argtypes = [ctypes.c_void_p]
        lib.dspmad_channels.argtypes = [ctypes.c_void_p]
        lib.dspmad_frames.restype = ctypes.c_long
        lib.dspmad_frames.argtypes = [ctypes.c_void_p]
        lib.dspmad_read.restype = ctypes.c_long
        lib.dspmad_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        lib.dspmad_seek.restype = ctypes.c_long
        lib.dspmad_seek.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.dspmad_close.argtypes = [ctypes.c_void_p]

    from dsp_tpu_torch.codecs.native import load_shim

    _lib = load_shim("libdspmad.so", _declare)
    return _lib


class Mp3Codec(Codec):
    def __init__(self, params):
        lib = _load()
        if not lib:
            raise CodecError("mp3: libdspmad.so not built (make -C native mad)")
        self._lib = lib
        self._h = lib.dspmad_open(params.path.encode())
        if not self._h:
            raise CodecError(f"mp3: failed to open: {params.path}")
        self.path = params.path
        self.type = "mp3"
        self.enc = "mad_f"
        self.prec = 24  # mp3.c:199
        self.fs = lib.dspmad_sample_rate(self._h)
        self.channels = lib.dspmad_channels(self._h)
        self.frames = int(lib.dspmad_frames(self._h))
        self.buf_ratio = params.buf_ratio

    def read(self, frames):
        buf = np.empty((frames, self.channels), dtype=np.float64)
        got = self._lib.dspmad_read(self._h, buf.ctypes.data, frames)
        return buf[:got]

    def seek(self, pos):
        return int(self._lib.dspmad_seek(self._h, max(0, pos)))

    def close(self):
        if self._h:
            self._lib.dspmad_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


if _load():
    register_codec(
        CodecInfo(
            name="mp3",
            modes=CODEC_MODE_READ,
            extensions=("mp3",),
            encodings=("mad_f",),
            init=Mp3Codec,
        )
    )
