"""libao playback via ctypes (reference: ao.c).

Import self-gates when libao is absent. Write-only; s16/u8/s32 like the
reference (ao.c:103-134); no delay/pause support (ao.c:131-134).
"""

import ctypes
import ctypes.util

import numpy as np

from dsp_tpu_torch.codecs.base import (
    CODEC_HINT_CAN_DITHER,
    CODEC_HINT_INTERACTIVE,
    CODEC_MODE_WRITE,
    Codec,
    CodecError,
    CodecInfo,
    register_codec,
)
from dsp_tpu_torch.codecs.sampleconv import encoding_info, sample_to_raw

_libname = ctypes.util.find_library("ao")
if _libname is None:
    raise ImportError("libao not available")
_ao = ctypes.CDLL(_libname)

AO_FMT_NATIVE = 4
_ENC_BITS = {"s16": 16, "u8": 8, "s32": 32}


class _AoSampleFormat(ctypes.Structure):
    _fields_ = [
        ("bits", ctypes.c_int),
        ("rate", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("byte_format", ctypes.c_int),
        ("matrix", ctypes.c_char_p),
    ]


_ao.ao_open_live.restype = ctypes.c_void_p
_ao.ao_play.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
_ao.ao_close.argtypes = [ctypes.c_void_p]  # 64-bit handle: avoid int truncation

_initialized = False


class AoCodec(Codec):
    def __init__(self, params):
        global _initialized
        if params.mode != CODEC_MODE_WRITE:
            raise CodecError("ao: write-only")
        enc = params.enc or "s16"
        if enc not in _ENC_BITS:
            raise CodecError(f"ao: unsupported encoding: {enc}")
        if not _initialized:
            _ao.ao_initialize()
            _initialized = True
        self.path = params.path
        self.type = "ao"
        self.enc = enc
        self.fs = params.fs
        self.channels = params.channels
        self.buf_ratio = params.buf_ratio
        self.prec = encoding_info(enc)[1]
        self.hints = CODEC_HINT_CAN_DITHER | CODEC_HINT_INTERACTIVE
        fmt = _AoSampleFormat(_ENC_BITS[enc], params.fs, params.channels, AO_FMT_NATIVE, None)
        drv = _ao.ao_default_driver_id()
        if drv < 0:
            raise CodecError("ao: no usable output device")
        self._dev = _ao.ao_open_live(drv, ctypes.byref(fmt), None)
        if not self._dev:
            raise CodecError("ao: failed to open device")
        self.frames = -1

    def write(self, buf):
        raw = sample_to_raw(np.asarray(buf, dtype=np.float64).ravel(), self.enc)
        if _ao.ao_play(self._dev, raw, len(raw)) == 0:
            raise CodecError("ao: playback error")
        return len(buf)

    def close(self):
        _ao.ao_close(self._dev)


register_codec(
    CodecInfo(
        name="ao",
        modes=CODEC_MODE_WRITE,
        extensions=(),
        init=AoCodec,
        encodings=tuple(_ENC_BITS),
    )
)
