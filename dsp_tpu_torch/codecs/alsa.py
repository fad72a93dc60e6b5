"""ALSA device I/O via ctypes on libasound (reference: alsa.c).

Import self-gates (raises ImportError) when libasound.so.2 is absent — the
analog of the reference's configure-time gating (configure:128-151). The full
ABI is declared so the codec is functional on any host with ALSA:

  * hw params: interleaved access, format/rate/channels, buffer sized
    ``block_frames * buf_ratio`` with >= 2 periods (alsa.c:239-279)
  * sw params: start threshold of 2 blocks (alsa.c:295)
  * xrun recovery on -EPIPE / -ESTRPIPE (alsa.c:54-72)
  * ``snd_pcm_delay`` for latency (alsa.c:131-139)
  * pause via hw pause when supported, else drop (alsa.c:150-169)
  * hints: CAN_DITHER for integer formats, INTERACTIVE on write, REALTIME
    (alsa.c:329-332)
"""

import ctypes
import ctypes.util
import os

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
from dsp_tpu_torch.codecs.sampleconv import raw_to_sample, sample_to_raw

_libname = ctypes.util.find_library("asound")
if _libname is None:
    # DSP_TPU_FAKE_ALSA=1 lets the test harness import the module and
    # monkeypatch `_a` with a scripted fake (tests/test_alsa_fake.py) on
    # hosts without libasound; default behavior (ImportError self-gating,
    # the analog of the reference's configure gating) is unchanged.
    if os.environ.get("DSP_TPU_FAKE_ALSA") != "1":
        raise ImportError("libasound not available")
    _a = None
else:
    _a = ctypes.CDLL(_libname)

# --- minimal ALSA ABI -------------------------------------------------------
SND_PCM_STREAM_PLAYBACK = 0
SND_PCM_STREAM_CAPTURE = 1
SND_PCM_ACCESS_RW_INTERLEAVED = 3
# snd_pcm_format_t values (asoundlib.h)
_FORMATS = {
    "s8": (0, True),
    "u8": (1, True),
    "s16": (2, True),  # S16_LE
    "s24": (6, True),  # S24_LE (32-bit container)
    "s24_3": (32, True),  # S24_3LE
    "s32": (10, True),  # S32_LE
    "float": (14, False),  # FLOAT_LE
    "double": (16, False),  # FLOAT64_LE
}
_EPIPE = 32
_ESTRPIPE = 86

if _a is not None:
    _a.snd_pcm_open.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    _a.snd_strerror.restype = ctypes.c_char_p
    _a.snd_pcm_hw_params_sizeof.restype = ctypes.c_size_t
    _a.snd_pcm_sw_params_sizeof.restype = ctypes.c_size_t
    _a.snd_pcm_writei.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong]
    _a.snd_pcm_writei.restype = ctypes.c_long
    _a.snd_pcm_readi.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong]
    _a.snd_pcm_readi.restype = ctypes.c_long


def _ck(err, what):
    if err < 0:
        raise CodecError(f"alsa: {what}: {_a.snd_strerror(err).decode()}")
    return err


class AlsaCodec(Codec):
    def __init__(self, params):
        if _a is None:
            # No libasound on this system: fail like the reference does when
            # snd_pcm_open can't reach a device, so codec dispatch's
            # device-fallback probe (codec.c:141-151) moves on / errors
            # cleanly instead of crashing on the missing handle.
            raise CodecError("alsa: libasound not available")
        enc = params.enc or "s16"
        if enc not in _FORMATS:
            raise CodecError(f"alsa: unsupported encoding: {enc}")
        fmt, is_int = _FORMATS[enc]
        self.path = params.path
        self.type = "alsa"
        self.enc = enc
        self.fs = params.fs
        self.channels = params.channels
        self.buf_ratio = params.buf_ratio
        self._block = params.block_frames
        self._mode = params.mode
        from dsp_tpu_torch.codecs.sampleconv import encoding_info

        _, bits, _ = encoding_info(enc)
        self.prec = bits
        self.hints = CODEC_HINT_REALTIME
        if is_int:
            self.hints |= CODEC_HINT_CAN_DITHER
        if params.mode & CODEC_MODE_WRITE:
            self.hints |= CODEC_HINT_INTERACTIVE
        stream = (
            SND_PCM_STREAM_PLAYBACK if params.mode & CODEC_MODE_WRITE else SND_PCM_STREAM_CAPTURE
        )
        pcm = ctypes.c_void_p()
        _ck(_a.snd_pcm_open(ctypes.byref(pcm), params.path.encode(), stream, 0), "open")
        self._pcm = pcm
        hw = ctypes.create_string_buffer(_a.snd_pcm_hw_params_sizeof())
        _ck(_a.snd_pcm_hw_params_any(pcm, hw), "hw_params_any")
        _ck(
            _a.snd_pcm_hw_params_set_access(pcm, hw, SND_PCM_ACCESS_RW_INTERLEAVED),
            "set_access",
        )
        _ck(_a.snd_pcm_hw_params_set_format(pcm, hw, fmt), "set_format")
        rate = ctypes.c_uint(params.fs)
        _ck(_a.snd_pcm_hw_params_set_rate_near(pcm, hw, ctypes.byref(rate), None), "set_rate")
        if rate.value != params.fs:
            raise CodecError(f"alsa: rate {params.fs} not supported (got {rate.value})")
        _ck(_a.snd_pcm_hw_params_set_channels(pcm, hw, params.channels), "set_channels")
        bufsize = ctypes.c_ulong(params.block_frames * max(2, params.buf_ratio))
        _ck(
            _a.snd_pcm_hw_params_set_buffer_size_near(pcm, hw, ctypes.byref(bufsize)),
            "set_buffer_size",
        )
        periods = ctypes.c_uint(max(2, params.buf_ratio))
        _ck(
            _a.snd_pcm_hw_params_set_periods_near(pcm, hw, ctypes.byref(periods), None),
            "set_periods",
        )
        _ck(_a.snd_pcm_hw_params(pcm, hw), "hw_params")
        self._can_pause = bool(_a.snd_pcm_hw_params_can_pause(hw))
        if params.mode & CODEC_MODE_WRITE:
            # sw params ONLY for playback, with the threshold clamped to the
            # actual device buffer (alsa.c:285-295) — applied to capture, a
            # 2-block start threshold would keep snd_pcm_readi of one block
            # from ever auto-starting the stream
            buf_frames = ctypes.c_ulong(0)
            _a.snd_pcm_hw_params_get_buffer_size(hw, ctypes.byref(buf_frames))
            thresh = 2 * params.block_frames
            if buf_frames.value:
                thresh = min(thresh, int(buf_frames.value))
            sw = ctypes.create_string_buffer(_a.snd_pcm_sw_params_sizeof())
            _ck(_a.snd_pcm_sw_params_current(pcm, sw), "sw_params_current")
            _ck(
                _a.snd_pcm_sw_params_set_start_threshold(
                    pcm, sw, ctypes.c_ulong(thresh)
                ),
                "start_threshold",
            )
            _ck(_a.snd_pcm_sw_params(pcm, sw), "sw_params")
        from dsp_tpu_torch.codecs.sampleconv import encoding_info as _ei

        self._frame_bytes = _ei(enc)[0] * params.channels
        self.frames = -1

    def _recover(self, err):
        # xrun / suspend recovery (alsa.c:54-72)
        if err == -_EPIPE:
            return _a.snd_pcm_prepare(self._pcm)
        if err == -_ESTRPIPE:
            import time as _time

            while True:
                r = _a.snd_pcm_resume(self._pcm)
                if r != -11:  # -EAGAIN
                    break
                _time.sleep(1.0)  # canonical ALSA recovery cadence, no busy-spin
            if r < 0:
                return _a.snd_pcm_prepare(self._pcm)
            return r
        return err

    def read(self, frames):
        buf = ctypes.create_string_buffer(frames * self._frame_bytes)
        got = 0
        while got < frames:
            n = _a.snd_pcm_readi(
                self._pcm,
                ctypes.byref(buf, got * self._frame_bytes),
                frames - got,
            )
            if n < 0:
                if self._recover(n) < 0:
                    raise CodecError(f"alsa: read: {_a.snd_strerror(int(n)).decode()}")
                continue
            if n == 0:
                break
            got += n
        raw = bytes(buf)[: got * self._frame_bytes]
        return raw_to_sample(raw, self.enc).reshape(-1, self.channels)

    def write(self, buf):
        raw = sample_to_raw(np.asarray(buf, dtype=np.float64).ravel(), self.enc)
        frames = len(buf)
        done = 0
        while done < frames:
            n = _a.snd_pcm_writei(
                self._pcm,
                raw[done * self._frame_bytes : ],
                frames - done,
            )
            if n < 0:
                if self._recover(int(n)) < 0:
                    raise CodecError(f"alsa: write: {_a.snd_strerror(int(n)).decode()}")
                continue
            done += int(n)
        return done

    def delay(self):
        # while paused, report the cached pre-pause delay (alsa.c:131-139)
        if getattr(self, "_paused", False):
            return getattr(self, "_delay_cache", 0)
        d = ctypes.c_long(0)
        if _a.snd_pcm_delay(self._pcm, ctypes.byref(d)) < 0:
            return 0
        self._delay_cache = int(d.value)
        return self._delay_cache

    def pause(self, p):
        # cache the delay at pause time (alsa.c:150-169); without hw pause,
        # playback DRAINS (buffered audio plays out) and capture drops
        d = ctypes.c_long(0)
        if _a.snd_pcm_delay(self._pcm, ctypes.byref(d)) >= 0:
            self._delay_cache = int(d.value)
        if self._can_pause:
            _a.snd_pcm_pause(self._pcm, 1 if p else 0)
        elif p and not getattr(self, "_paused", False):
            if self._mode & CODEC_MODE_WRITE:
                _a.snd_pcm_drain(self._pcm)
            else:
                _a.snd_pcm_drop(self._pcm)
            _a.snd_pcm_prepare(self._pcm)
        self._paused = bool(p)

    def drop(self):
        _a.snd_pcm_drop(self._pcm)
        _a.snd_pcm_prepare(self._pcm)

    def close(self):
        if self._mode & CODEC_MODE_WRITE:
            _a.snd_pcm_drain(self._pcm)
        _a.snd_pcm_close(self._pcm)


register_codec(
    CodecInfo(
        name="alsa",
        modes=CODEC_MODE_READ | CODEC_MODE_WRITE,
        extensions=(),
        init=AlsaCodec,
        encodings=tuple(_FORMATS),
    )
)
