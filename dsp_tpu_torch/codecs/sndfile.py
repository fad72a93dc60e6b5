"""Optional libsndfile backend via the `soundfile` package.

Mirrors the reference's sndfile.c: broad container/encoding support when
libsndfile is present; gated out (ImportError) otherwise, exactly like the
reference's configure-time gating (configure:128-135).
"""

import numpy as np
import soundfile as _sf  # raises ImportError when unavailable -> codec gated out

from dsp_tpu_torch.codecs.base import (
    CODEC_HINT_CAN_DITHER,
    CODEC_MODE_READ,
    CODEC_MODE_WRITE,
    Codec,
    CodecError,
    CodecInfo,
    register_codec,
)

_SUBTYPE_TO_ENC = {
    "PCM_S8": ("s8", 8, True),
    "PCM_U8": ("u8", 8, True),
    "PCM_16": ("s16", 16, True),
    "PCM_24": ("s24", 24, True),
    "PCM_32": ("s32", 32, True),
    "FLOAT": ("float", 24, False),
    "DOUBLE": ("double", 53, False),
    "ULAW": ("mu-law", 13, False),
    "ALAW": ("a-law", 13, False),
    "VORBIS": ("vorbis", 23, False),
    "OPUS": ("opus", 23, False),
    "FLAC": ("flac", 16, True),
    "MPEG_LAYER_III": ("mpeg2.3", 23, False),
}
_ENC_TO_SUBTYPE = {
    "s8": "PCM_S8",
    "u8": "PCM_U8",
    "s16": "PCM_16",
    "s24": "PCM_24",
    "s32": "PCM_32",
    "float": "FLOAT",
    "double": "DOUBLE",
    "mu-law": "ULAW",
    "a-law": "ALAW",
    "vorbis": "VORBIS",
    "opus": "OPUS",
}


class SndfileCodec(Codec):
    def __init__(self, params):
        self.path = params.path
        self.type = params.type or "sndfile"
        self.buf_ratio = params.buf_ratio
        if params.mode == CODEC_MODE_READ:
            try:
                self._sf = _sf.SoundFile(params.path, "r")
            except Exception as e:
                raise CodecError(f"sndfile: {params.path}: {e}")
            self.mode = CODEC_MODE_READ
        else:
            fmt = (params.type or "wav").upper()
            if fmt in ("SNDFILE", "SF"):
                # extension-dispatched write: the container must follow the
                # file's extension (the reference registers one codec type
                # per major format, sndfile.c:44-69) — a fixed WAV here
                # would write RIFF bytes into out.flac
                i = params.path.rfind(".")
                ext = params.path[i + 1 :].upper() if i >= 0 else ""
                alias = {"AIF": "AIFF", "OGA": "OGG", "OPUS": "OGG"}
                ext = alias.get(ext, ext)
                fmt = ext if ext in _sf.available_formats() else "WAV"
            subtype = _ENC_TO_SUBTYPE.get(params.enc or "s16", "PCM_16")
            try:
                self._sf = _sf.SoundFile(
                    params.path,
                    "w",
                    samplerate=params.fs,
                    channels=params.channels,
                    format=fmt,
                    subtype=subtype,
                )
            except Exception as e:
                raise CodecError(f"sndfile: {params.path}: {e}")
            self.mode = CODEC_MODE_WRITE
        self.fs = self._sf.samplerate
        self.channels = self._sf.channels
        enc, prec, can_dither = _SUBTYPE_TO_ENC.get(
            self._sf.subtype, (self._sf.subtype.lower(), 23, False)
        )
        self.enc = enc
        self.prec = prec
        self.hints = CODEC_HINT_CAN_DITHER if can_dither else 0
        self.frames = self._sf.frames if self.mode == CODEC_MODE_READ else -1
        self._pos = 0

    def read(self, frames):
        buf = self._sf.read(frames, dtype="float64", always_2d=True)
        self._pos += len(buf)
        return buf

    def write(self, buf):
        self._sf.write(np.asarray(buf, dtype=np.float64))
        self._pos += len(buf)
        return len(buf)

    def seek(self, pos):
        try:
            p = self._sf.seek(pos)
        except Exception:
            return -1
        self._pos = p
        return p

    def close(self):
        self._sf.close()


register_codec(
    CodecInfo(
        name="sndfile",
        modes=CODEC_MODE_READ | CODEC_MODE_WRITE,
        extensions=("flac", "ogg", "oga", "opus", "aiff", "aif", "au", "caf", "w64", "rf64"),
        init=SndfileCodec,
    )
)
