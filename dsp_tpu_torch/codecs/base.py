"""Codec protocol, registry, and dispatch (reference: codec.c).

A codec reads or writes interleaved float64 blocks shaped [frames, channels].
Dispatch order mirrors init_codec (codec.c:175-232): explicit type -> extension
match -> fallback probe list (log-suppressed probing).
"""

from dataclasses import dataclass, replace

import numpy as np

from dsp_tpu_torch.core import log

CODEC_MODE_READ = 1 << 0
CODEC_MODE_WRITE = 1 << 1

CODEC_ENDIAN_DEFAULT = 0
CODEC_ENDIAN_BIG = 1
CODEC_ENDIAN_LITTLE = 2
CODEC_ENDIAN_NATIVE = 3

CODEC_HINT_INTERACTIVE = 1 << 0
CODEC_HINT_CAN_DITHER = 1 << 1
CODEC_HINT_NO_BUF = 1 << 2
CODEC_HINT_REALTIME = 1 << 3


class CodecError(Exception):
    pass


@dataclass
class CodecParams:
    path: str
    type: str | None = None
    enc: str | None = None
    fs: int = 44100
    channels: int = 1
    endian: int = CODEC_ENDIAN_DEFAULT
    mode: int = CODEC_MODE_READ
    block_frames: int = 2048
    buf_ratio: int = 64


class Codec:
    """Base codec. Subclasses implement read/write/seek/close."""

    path: str
    type: str
    enc: str
    fs: int
    channels: int
    prec: int = 53
    hints: int = 0
    buf_ratio: int = 1
    frames: int = -1  # -1 = unknown / infinite

    def read(self, frames: int) -> np.ndarray:
        """Return up to `frames` frames as float64 [n, channels]; 0 rows at EOF."""
        raise CodecError(f"{self.type}: not readable")

    def write(self, buf: np.ndarray) -> int:
        raise CodecError(f"{self.type}: not writable")

    def seek(self, pos: int) -> int:
        return -1

    def delay(self) -> int:
        return 0

    def drop(self) -> None:
        pass

    def pause(self, p: bool) -> None:
        pass

    def close(self) -> None:
        pass


@dataclass
class CodecInfo:
    name: str
    modes: int
    extensions: tuple = ()
    init: object = None
    encodings: tuple = ()


_REGISTRY: list[CodecInfo] = []


def register_codec(info: CodecInfo):
    _REGISTRY.append(info)


def get_codec_info_by_type(t):
    for ci in _REGISTRY:
        if ci.name == t:
            return ci
    return None


def get_codec_info_by_ext(ext, mode):
    for ci in _REGISTRY:
        if (ci.modes & mode) and ext in ci.extensions:
            return ci
    return None


def _file_ext(path):
    i = path.rfind(".")
    return path[i + 1 :].lower() if i >= 0 else ""


# Probe fallbacks mirroring codec.c:200-231: sndfile/ffmpeg (+ own wav
# prober) for unknown read files; pulse/alsa/ao for write devices (these
# register only when their libraries exist; an output probe that finds none
# fails).
_READ_FALLBACKS = ["sndfile", "wav", "ffmpeg"]
# device codecs only, like fallback_output_codecs (codec.c:141-151): an
# unmatched output path must ERROR, not silently discard audio via null
_WRITE_FALLBACKS = ["pulse", "alsa", "ao"]


def init_codec(params: CodecParams) -> Codec:
    if params.type:
        ci = get_codec_info_by_type(params.type)
        if ci is None:
            raise CodecError(f"{params.path}: unknown codec type: {params.type}")
        if not (ci.modes & params.mode):
            mode_s = "read" if params.mode == CODEC_MODE_READ else "write"
            raise CodecError(f"{params.path}: codec {ci.name} does not support {mode_s}")
        return ci.init(params)
    ext = _file_ext(params.path)
    errors = []
    ci = get_codec_info_by_ext(ext, params.mode)
    if ci is not None:
        # an extension-matched codec that fails to open falls through to
        # the fallback probes (codec.c:202-208): e.g. an MP3 mislabeled
        # .wav still decodes via sndfile/ffmpeg
        try:
            return ci.init(replace(params, type=ci.name))
        except (CodecError, OSError, ValueError) as e:
            errors.append(f"{ci.name}: {e}")
    fallbacks = _READ_FALLBACKS if params.mode == CODEC_MODE_READ else _WRITE_FALLBACKS
    for name in fallbacks:
        ci = get_codec_info_by_type(name)
        if ci is None or not (ci.modes & params.mode):
            continue
        try:
            return ci.init(replace(params, type=name))
        except (CodecError, OSError, ValueError) as e:
            errors.append(f"{name}: {e}")
    raise CodecError(
        f"{params.path}: no codec found" + (": " + "; ".join(errors) if errors else "")
    )


def print_all_codecs(file=None):
    import sys

    f = file or sys.stdout
    f.write("Types:\n  Type:    Modes: Encodings:\n")
    for ci in _REGISTRY:
        encs = " ".join(ci.encodings) if ci.encodings else "<autodetected>"
        r = "r" if ci.modes & CODEC_MODE_READ else " "
        w = "w" if ci.modes & CODEC_MODE_WRITE else " "
        f.write(f"  {ci.name:<8s} {r}{w}     {encs}\n")


def _register_builtins():
    # imports at call time to avoid cycles; order = codec.c's table order
    # (null, sgen, ffmpeg, pcm, wavpipe) with dsp_tpu's additions after, as
    # dsp_tpu/codecs/base.py registers them
    from dsp_tpu_torch.codecs import null as _null  # noqa: F401
    from dsp_tpu_torch.codecs import sgen as _sgen  # noqa: F401

    try:
        from dsp_tpu_torch.codecs import sndfile as _sndfile  # noqa: F401
    except ImportError:
        log.verbose("codecs: libsndfile support unavailable")
    from dsp_tpu_torch.codecs import mp3 as _mp3  # noqa: F401 (self-gating, HAVE_MAD analog)
    from dsp_tpu_torch.codecs import ffmpeg as _ffmpeg  # noqa: F401 (self-gating)
    from dsp_tpu_torch.codecs import pcm as _pcm  # noqa: F401
    from dsp_tpu_torch.codecs import wav as _wav  # noqa: F401
    # device codecs gate on their system libraries (configure:128-151 analog)
    for _dev in ("alsa", "pulse", "ao"):
        try:
            __import__(f"dsp_tpu_torch.codecs.{_dev}")
        except ImportError:
            log.verbose("codecs: %s support unavailable", _dev)


_register_builtins()
