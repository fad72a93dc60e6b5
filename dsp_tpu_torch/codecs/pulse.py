"""PulseAudio device I/O via ctypes on libpulse-simple (reference: pulse.c).

Import self-gates when libpulse-simple.so.0 is absent (configure:128-151
analog). Duplex simple-API stream; latency via ``pa_simple_get_latency``
(pulse.c:75-79).
"""

import ctypes
import ctypes.util

import numpy as np

from dsp_tpu_torch.codecs.base import (
    CODEC_HINT_CAN_DITHER,
    CODEC_HINT_INTERACTIVE,
    CODEC_HINT_REALTIME,
    CODEC_MODE_READ,
    CODEC_MODE_WRITE,
    Codec,
    CodecError,
    CodecInfo,
    register_codec,
)
from dsp_tpu_torch.codecs.sampleconv import encoding_info, raw_to_sample, sample_to_raw

_libname = ctypes.util.find_library("pulse-simple")
if _libname is None:
    raise ImportError("libpulse-simple not available")
_p = ctypes.CDLL(_libname)

PA_STREAM_PLAYBACK = 1
PA_STREAM_RECORD = 2
# pa_sample_format_t
_FORMATS = {
    "u8": (0, True),
    "a-law": (1, False),
    "mu-law": (2, False),
    "s16": (3, True),  # S16LE
    "float": (5, False),  # FLOAT32LE
    "s32": (7, True),  # S32LE
    "s24_3": (9, True),  # S24LE (packed)
    "s24": (11, True),  # S24_32LE
}


class _SampleSpec(ctypes.Structure):
    _fields_ = [("format", ctypes.c_int), ("rate", ctypes.c_uint32), ("channels", ctypes.c_uint8)]


_p.pa_simple_new.restype = ctypes.c_void_p
_p.pa_simple_new.argtypes = [
    ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
    ctypes.POINTER(_SampleSpec), ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_int),
]
# every pa_simple_* taking the stream handle needs c_void_p argtypes: the
# handle comes back as a Python int (c_void_p restype) and ctypes would
# otherwise truncate it to a 32-bit C int on 64-bit hosts -> segfault
_p.pa_simple_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                              ctypes.POINTER(ctypes.c_int)]
_p.pa_simple_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_int)]
_p.pa_simple_flush.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
_p.pa_simple_drain.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
_p.pa_simple_free.argtypes = [ctypes.c_void_p]
_p.pa_simple_get_latency.restype = ctypes.c_uint64
_p.pa_simple_get_latency.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
_p.pa_strerror.restype = ctypes.c_char_p


class PulseCodec(Codec):
    def __init__(self, params):
        enc = params.enc or "s16"
        if enc not in _FORMATS:
            raise CodecError(f"pulse: unsupported encoding: {enc}")
        fmt, is_int = _FORMATS[enc]
        self.path = params.path
        self.type = "pulse"
        self.enc = enc
        self.fs = params.fs
        self.channels = params.channels
        self.buf_ratio = params.buf_ratio
        self._mode = params.mode
        self.prec = encoding_info(enc)[1]
        self.hints = CODEC_HINT_REALTIME
        if is_int:
            self.hints |= CODEC_HINT_CAN_DITHER
        if params.mode & CODEC_MODE_WRITE:
            self.hints |= CODEC_HINT_INTERACTIVE
        spec = _SampleSpec(fmt, params.fs, params.channels)
        err = ctypes.c_int(0)
        direction = PA_STREAM_PLAYBACK if params.mode & CODEC_MODE_WRITE else PA_STREAM_RECORD
        dev = params.path.encode() if params.path not in ("", "default") else None
        self._s = _p.pa_simple_new(
            None, b"dsp", direction, dev, b"dsp", ctypes.byref(spec), None, None,
            ctypes.byref(err),
        )
        if not self._s:
            raise CodecError(f"pulse: {_p.pa_strerror(err).decode()}")
        self._frame_bytes = encoding_info(enc)[0] * params.channels
        self.frames = -1

    def read(self, frames):
        err = ctypes.c_int(0)
        buf = ctypes.create_string_buffer(frames * self._frame_bytes)
        if _p.pa_simple_read(self._s, buf, len(buf), ctypes.byref(err)) < 0:
            raise CodecError(f"pulse: read: {_p.pa_strerror(err).decode()}")
        return raw_to_sample(bytes(buf), self.enc).reshape(-1, self.channels)

    def write(self, buf):
        err = ctypes.c_int(0)
        raw = sample_to_raw(np.asarray(buf, dtype=np.float64).ravel(), self.enc)
        if _p.pa_simple_write(self._s, raw, len(raw), ctypes.byref(err)) < 0:
            raise CodecError(f"pulse: write: {_p.pa_strerror(err).decode()}")
        return len(buf)

    def delay(self):
        err = ctypes.c_int(0)
        usec = _p.pa_simple_get_latency(self._s, ctypes.byref(err))
        return int(usec * self.fs // 1_000_000)

    def drop(self):
        err = ctypes.c_int(0)
        _p.pa_simple_flush(self._s, ctypes.byref(err))

    def close(self):
        if self._mode & CODEC_MODE_WRITE:
            err = ctypes.c_int(0)
            _p.pa_simple_drain(self._s, ctypes.byref(err))
        _p.pa_simple_free(self._s)


register_codec(
    CodecInfo(
        name="pulse",
        modes=CODEC_MODE_READ | CODEC_MODE_WRITE,
        extensions=(),
        init=PulseCodec,
        encodings=tuple(_FORMATS),
    )
)
