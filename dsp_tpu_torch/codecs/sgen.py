"""sgen: signal generator input codec (reference: sgen.c).

Path grammar: ``[type[@chsel][:arg[=value]...]][/type...][+len]`` where type is
``sine`` (tones and exponential sweeps) or ``delta`` (impulse with offset).
Generators sum into the buffer on their selected channels. An exponential
sweep runs sin(w0/v * (e^{vt} - 1)) with v = ln(w1/w0)/T (sgen.c:55-67).
"""

import numpy as np

from dsp_tpu_torch.codecs.base import (
    CODEC_HINT_NO_BUF,
    CODEC_MODE_READ,
    Codec,
    CodecError,
    CodecInfo,
    register_codec,
)
from dsp_tpu_torch.core.parse import ParseError, parse_freq, parse_len, parse_selector, parse_timespec


def _isolate(s, c):
    """Split at first c: returns (head, tail-after-c or '')."""
    i = s.find(c)
    if i < 0:
        return s, ""
    return s[:i], s[i + 1 :]


class _Gen:
    __slots__ = ("type", "selector", "offset", "freq0", "freq1", "v")

    def __init__(self):
        self.type = None
        self.selector = None
        self.offset = 0
        self.freq0 = 440.0 * 2 * np.pi
        self.freq1 = 440.0 * 2 * np.pi
        self.v = 0.0


class SgenCodec(Codec):
    def __init__(self, params):
        self.path = params.path
        self.type = "sgen"
        self.enc = "sample_t"
        self.fs = params.fs
        self.channels = params.channels
        self.prec = 53
        self.hints = CODEC_HINT_NO_BUF
        self.buf_ratio = 1
        self.frames = -1
        self._pos = 0
        self._gens = []
        self._parse(params.path)

    def _parse(self, path):
        arg, len_str = _isolate(path, "+")
        if len_str:
            frames, rest = parse_timespec(len_str, self.fs)
            if rest:
                raise CodecError(f"sgen: failed to parse length: {len_str!r}")
            if frames <= 0:
                raise CodecError("sgen: length cannot be <= 0")
            self.frames = frames
        while arg:
            this, arg = _isolate(arg, "/")
            head, rest = _isolate(this, ":")
            gen_type, sel = _isolate(head, "@")
            g = _Gen()
            g.selector = np.ones(self.channels, dtype=bool)
            if gen_type == "delta":
                g.type = "delta"
            elif gen_type == "sine":
                g.type = "sine"
                g.freq0 = g.freq1 = 440.0
            else:
                raise CodecError(f"sgen: illegal type: {gen_type}")
            if sel:
                try:
                    g.selector = parse_selector(sel, self.channels)
                except ParseError as e:
                    raise CodecError(f"sgen: {e}")
            while rest:
                kv, rest = _isolate(rest, ":")
                key, value = _isolate(kv, "=")
                self._parse_param(g, key, value)
            self._prepare(g)
            self._gens.append(g)

    def _parse_param(self, g, key, value):
        if g.type == "delta":
            if key == "offset":
                off, rest = parse_len(value, self.fs, partial=True)
                if rest:
                    raise CodecError(f"sgen: failed to parse {key}: {value!r}")
                if off < 0 or (self.frames > 0 and off >= self.frames):
                    raise CodecError(f"sgen: {key} out of range")
                g.offset = off
            else:
                raise CodecError(f"sgen: delta: illegal parameter: {key}")
        elif g.type == "sine":
            if key == "freq":
                v0, v1s = _isolate(value, "-")
                g.freq0 = self._freq(v0, key)
                g.freq1 = self._freq(v1s, key) if v1s else g.freq0
            else:
                raise CodecError(f"sgen: sine: illegal parameter: {key}")

    def _freq(self, s, key):
        try:
            f = parse_freq(s)
        except ParseError:
            raise CodecError(f"sgen: failed to parse {key}: {s!r}")
        if f <= 0.0 or f >= self.fs / 2.0:
            raise CodecError(f"sgen: {key} out of range")
        return f

    def _prepare(self, g):
        if g.type == "sine":
            g.freq0 *= 2.0 * np.pi
            g.freq1 *= 2.0 * np.pi
            if self.frames > 0 and g.freq0 != g.freq1:
                g.v = np.log(g.freq1 / g.freq0) / (self.frames / self.fs)
            else:
                g.v = 0.0

    def read(self, frames):
        if self.frames > 0 and self._pos + frames > self.frames:
            frames = self.frames - self._pos
        if frames <= 0:
            return np.zeros((0, self.channels), dtype=np.float64)
        buf = np.zeros((frames, self.channels), dtype=np.float64)
        for g in self._gens:
            if g.type == "delta":
                idx = g.offset - self._pos
                if 0 <= idx < frames:
                    buf[idx, g.selector] += 1.0
            else:  # sine
                t = (self._pos + np.arange(frames, dtype=np.float64)) / self.fs
                if g.v != 0.0:
                    s = np.sin(g.freq0 / g.v * (np.exp(t * g.v) - 1.0))
                else:
                    s = np.sin(g.freq0 * t)
                buf[:, g.selector] += s[:, None]
        self._pos += frames
        return buf

    def seek(self, pos):
        pos = max(0, pos)
        if self.frames > 0:
            pos = min(pos, self.frames)
        self._pos = pos
        return pos


register_codec(
    CodecInfo(name="sgen", modes=CODEC_MODE_READ, init=SgenCodec, encodings=("sample_t",))
)
