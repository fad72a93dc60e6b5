"""WAV (RIFF) file codec: read/write without external libraries.

The reference reaches wav through libsndfile (sndfile.c); hosts aren't
guaranteed libsndfile, so this is a native RIFF implementation
covering the PCM-family encodings (u8/s16/s24/s24_3/s32/float/double) plus
G.711 mu-law/a-law, WAVE_FORMAT_EXTENSIBLE, and RF64/W64-style large sizes on
read. Other compressed encodings (ADPCM, GSM, ...) require the optional
sndfile backend, mirroring how the reference gates them on libsndfile.
"""

import io
import os
import struct
import sys

import numpy as np

from dsp_tpu_torch.codecs import sampleconv
from dsp_tpu_torch.codecs.base import (
    CODEC_HINT_CAN_DITHER,
    CODEC_MODE_READ,
    CODEC_MODE_WRITE,
    Codec,
    CodecError,
    CodecInfo,
    register_codec,
)

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

_WRITE_ENCODINGS = ("s16", "u8", "s24", "s24_3", "s32", "float", "double", "mu-law", "a-law")


def _enc_to_fmt(enc):
    if enc in ("float", "double"):
        return WAVE_FORMAT_IEEE_FLOAT
    if enc == "mu-law":
        return WAVE_FORMAT_MULAW
    if enc == "a-law":
        return WAVE_FORMAT_ALAW
    return WAVE_FORMAT_PCM


class WavReader(Codec):
    def __init__(self, params):
        self.path = params.path
        self.type = "wav"
        self.fs = params.fs
        self.channels = params.channels
        self.buf_ratio = params.buf_ratio
        self._f = open(params.path, "rb") if params.path != "-" else sys.stdin.buffer
        try:
            self._parse_header()
        except (struct.error, EOFError) as e:
            raise CodecError(f"wav: {params.path}: bad header: {e}")
        bps, prec, can_dither = sampleconv.encoding_info(self.enc)
        self._bps = bps
        self.prec = prec
        self.hints = CODEC_HINT_CAN_DITHER if can_dither else 0
        self._frame_bytes = self._bps * self.channels
        self._pos = 0
        # native prefetching reader (dspio); wav data is little-endian
        self._native = None
        if params.path != "-" and self.enc not in ("mu-law", "a-law"):
            from dsp_tpu_torch.codecs import native

            if native.available():
                try:
                    self._native = native.NativeReader(
                        params.path, self.enc, self.channels, self._data_off, self.frames
                    )
                except OSError:
                    self._native = None

    def _parse_header(self):
        f = self._f
        magic = f.read(4)
        if magic not in (b"RIFF", b"RF64"):
            raise CodecError("wav: not a RIFF file")
        riff_size = struct.unpack("<I", f.read(4))[0]
        if f.read(4) != b"WAVE":
            raise CodecError("wav: not a WAVE file")
        ds64_data_size = None
        fmt = None
        data_off = None
        data_size = None
        pos = 12  # bytes consumed so far (RIFF hdr); tell() raises on pipes
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            pos += 8
            cid, size = struct.unpack("<4sI", hdr)
            if cid == b"ds64":
                body = f.read(size)
                pos += len(body)
                # riff_size(8) data_size(8) sample_count(8) ...
                ds64_data_size = struct.unpack("<q", body[8:16])[0]
            elif cid == b"fmt ":
                body = f.read(size)
                pos += len(body)
                fmt = struct.unpack("<HHIIHH", body[:16])
                if fmt[0] == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                    # base bytes(16) + cbSize(2) + validBits(2) + mask(4), then
                    # the GUID whose first 2 bytes carry the base format code
                    guid_fmt = struct.unpack("<H", body[24:26])[0]
                    fmt = (guid_fmt,) + fmt[1:]
            elif cid == b"data":
                data_off = pos
                data_size = size if size != 0xFFFFFFFF else None
                if ds64_data_size is not None and size == 0xFFFFFFFF:
                    data_size = ds64_data_size
                break
            else:
                skip = size + (size & 1)
                try:
                    f.seek(skip, io.SEEK_CUR)
                except (OSError, io.UnsupportedOperation):
                    # non-seekable stream (stdin pipe): read and discard —
                    # ffmpeg-produced WAVs carry LIST/INFO chunks before data
                    left = skip
                    while left > 0:
                        junk = f.read(min(left, 1 << 16))
                        if not junk:
                            raise CodecError("wav: truncated chunk")
                        left -= len(junk)
                pos += skip
        if fmt is None or data_off is None:
            raise CodecError("wav: missing fmt or data chunk")
        (wformat, channels, fs, _byte_rate, _block_align, bits) = fmt
        self.fs = fs
        self.channels = channels
        if wformat == WAVE_FORMAT_PCM:
            self.enc = {8: "u8", 16: "s16", 24: "s24_3", 32: "s32"}.get(bits)
        elif wformat == WAVE_FORMAT_IEEE_FLOAT:
            self.enc = {32: "float", 64: "double"}.get(bits)
        elif wformat == WAVE_FORMAT_MULAW:
            self.enc = "mu-law"
        elif wformat == WAVE_FORMAT_ALAW:
            self.enc = "a-law"
        else:
            self.enc = None
        if self.enc is None:
            raise CodecError(f"wav: unsupported format {wformat}/{bits}bit")
        self._data_off = data_off
        frame_bytes = (bits // 8) * channels
        if data_size is None:
            try:
                end = os.fstat(self._f.fileno()).st_size
                data_size = end - data_off
            except (OSError, io.UnsupportedOperation):
                data_size = None
        self.frames = (data_size // frame_bytes) if data_size is not None else -1

    def read(self, frames):
        if self.frames >= 0:
            frames = min(frames, self.frames - self._pos)
        if frames <= 0:
            return np.zeros((0, self.channels), dtype=np.float64)
        if self._native is not None:
            buf = self._native.read(frames)
            self._pos += len(buf)
            return buf
        data = self._f.read(frames * self._frame_bytes)
        n = len(data) // self._frame_bytes
        buf = sampleconv.raw_to_sample(data[: n * self._frame_bytes], self.enc, "<")
        self._pos += n
        return buf.reshape(n, self.channels)

    def seek(self, pos):
        if not self._f.seekable():
            return -1
        pos = min(max(pos, 0), self.frames) if self.frames >= 0 else max(pos, 0)
        if self._native is not None:
            self._native.seek(pos)
        else:
            self._f.seek(self._data_off + pos * self._frame_bytes)
        self._pos = pos
        return pos

    def close(self):
        if self._native is not None:
            self._native.close()
            self._native = None
        if self._f is not getattr(sys.stdin, "buffer", None):
            self._f.close()


class WavWriter(Codec):
    def __init__(self, params):
        enc = params.enc or "s16"
        if enc not in _WRITE_ENCODINGS:
            raise CodecError(f"wav: unsupported encoding: {enc}")
        self.path = params.path
        self.type = "wav"
        self.enc = enc
        self.fs = params.fs
        self.channels = params.channels
        # s24 in wav is stored packed in 3 bytes (same as s24_3)
        bps, prec, can_dither = sampleconv.encoding_info("s24_3" if enc == "s24" else enc)
        self._bps = bps
        self.prec = prec
        self.hints = CODEC_HINT_CAN_DITHER if can_dither else 0
        self.buf_ratio = params.buf_ratio
        self.frames = -1
        self._f = open(params.path, "wb") if params.path != "-" else sys.stdout.buffer
        self._data_bytes = 0
        self._write_header(0)
        self._pos = 0

    def _write_header(self, data_bytes):
        fmt = _enc_to_fmt(self.enc)
        block_align = self._bps * self.channels
        use_ext = fmt == WAVE_FORMAT_PCM and self.enc in ("s24", "s32") and self.channels > 2
        fmt_body = struct.pack(
            "<HHIIHH",
            fmt,
            self.channels,
            self.fs,
            self.fs * block_align,
            block_align,
            self._bps * 8,
        )
        if fmt in (WAVE_FORMAT_IEEE_FLOAT, WAVE_FORMAT_MULAW, WAVE_FORMAT_ALAW):
            fmt_body += struct.pack("<H", 0)  # cbSize
        fmt_chunk = b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
        fact_chunk = b""
        if fmt != WAVE_FORMAT_PCM:
            nframes = data_bytes // block_align
            fact_chunk = b"fact" + struct.pack("<II", 4, nframes)
        data_hdr = b"data" + struct.pack("<I", data_bytes)
        riff_size = 4 + len(fmt_chunk) + len(fact_chunk) + len(data_hdr) + data_bytes
        self._f.write(b"RIFF" + struct.pack("<I", riff_size) + b"WAVE")
        self._f.write(fmt_chunk)
        if fact_chunk:
            self._f.write(fact_chunk)
        self._f.write(data_hdr)
        _ = use_ext  # extensible container not required for these encodings

    def write(self, buf):
        # s24 in wav is stored packed (3 bytes); map container enc accordingly
        enc = "s24_3" if self.enc == "s24" else self.enc
        data = sampleconv.sample_to_raw(np.asarray(buf).reshape(-1), enc, "<")
        self._f.write(data)
        self._data_bytes += len(data)
        self._pos += len(buf)
        return len(buf)

    def close(self):
        if self._f.seekable():
            self._f.seek(0)
            self._write_header(self._data_bytes)
        if self._f is not getattr(sys.stdout, "buffer", None):
            self._f.close()


def _wav_init(params):
    if params.mode == CODEC_MODE_READ:
        return WavReader(params)
    return WavWriter(params)


register_codec(
    CodecInfo(
        name="wav",
        modes=CODEC_MODE_READ | CODEC_MODE_WRITE,
        extensions=("wav", "wave"),
        init=_wav_init,
        encodings=_WRITE_ENCODINGS,
    )
)
