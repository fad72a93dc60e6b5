"""ffmpeg codec: read-only decode of anything libavformat/libavcodec handle
(reference: ffmpeg.c).

The reference dlopens libav* symbols one by one (dlsym.h); here a small C++
shim (native/dspav.cpp, built with ``make -C native libdspav.so``) links the
same libraries behind a stable C ABI and ctypes loads the shim. Gated out
(no registration) when the shim or the libraries are unavailable, exactly
like the reference's configure-time gating.
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
        lib.dspav_open.restype = ctypes.c_void_p
        lib.dspav_open.argtypes = [ctypes.c_char_p]
        lib.dspav_channels.argtypes = [ctypes.c_void_p]
        lib.dspav_sample_rate.argtypes = [ctypes.c_void_p]
        lib.dspav_frames.restype = ctypes.c_int64
        lib.dspav_frames.argtypes = [ctypes.c_void_p]
        lib.dspav_read.restype = ctypes.c_int64
        lib.dspav_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.dspav_seek.restype = ctypes.c_int64
        lib.dspav_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.dspav_close.argtypes = [ctypes.c_void_p]
        lib.dspav_sample_fmt_name.restype = ctypes.c_char_p
        lib.dspav_sample_fmt_name.argtypes = [ctypes.c_void_p]

    from dsp_tpu_torch.codecs.native import load_shim

    _lib = load_shim("libdspav.so", _declare)
    return _lib


class FfmpegCodec(Codec):
    def __init__(self, params):
        lib = _load()
        if not lib:
            raise CodecError("ffmpeg: libdspav.so not available")
        self._lib = lib
        self._h = lib.dspav_open(params.path.encode())
        if not self._h:
            raise CodecError(f"ffmpeg: failed to open: {params.path}")
        self.path = params.path
        self.type = "ffmpeg"
        fmt = lib.dspav_sample_fmt_name(self._h)
        self.enc = fmt.decode() if fmt else "autodetected"
        self.fs = lib.dspav_sample_rate(self._h)
        self.channels = lib.dspav_channels(self._h)
        self.frames = int(lib.dspav_frames(self._h))
        # precision + dither eligibility from the decoder's sample format
        # (ffmpeg.c:396-430): integer formats can dither
        base = self.enc.rstrip("p")
        prec_map = {"u8": 8, "s16": 16, "s32": 32, "s64": 32, "flt": 24, "dbl": 53}
        self.prec = prec_map.get(base, 24)
        if base in ("u8", "s16", "s32", "s64"):
            from dsp_tpu_torch.codecs.base import CODEC_HINT_CAN_DITHER

            self.hints |= CODEC_HINT_CAN_DITHER
        self.buf_ratio = params.buf_ratio

    def read(self, frames):
        buf = np.empty((frames, self.channels), dtype=np.float64)
        got = self._lib.dspav_read(self._h, buf.ctypes.data, frames)
        return buf[:got]

    def seek(self, pos):
        # reference clamping (ffmpeg.c:232-237): unknown length refuses the
        # seek; at/past EOF clamps to the final frame
        if self.frames < 0:
            return -1
        pos = min(max(0, pos), self.frames - 1)
        return int(self._lib.dspav_seek(self._h, pos))

    def close(self):
        if self._h:
            self._lib.dspav_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


if _load():
    register_codec(
        CodecInfo(
            name="ffmpeg",
            modes=CODEC_MODE_READ,
            extensions=("mp3", "m4a", "aac", "ogg", "oga", "opus", "flac", "wma", "mka", "webm"),
            init=FfmpegCodec,
        )
    )
