"""Filter loading and option parsing shared by fir/fir_p/zita_convolver/hilbert
(reference: fir_util.c).

Filters come from ``coefs:`` inline lists (comma-separated per channel,
'/'-separated channels, missing values zero-filled) or from any codec file
(with %r/%k/%c path substitution and optional explicit type/enc/rate/channels
for raw files). The ``-a[offset]`` option aligns channels to the filter's
peak sample (offset 0/unset) or a fixed offset from the start (>0) / end (<0),
consumed by the chain alignment pass as a negative requested delay.
"""

from dataclasses import dataclass, field

import numpy as np

from dsp_tpu_torch.codecs.base import CODEC_ENDIAN_BIG, CODEC_ENDIAN_LITTLE, CODEC_MODE_READ, CodecError, CodecParams, init_codec
from dsp_tpu_torch.core import log
from dsp_tpu_torch.core.parse import (
    ParseError,
    construct_full_path,
    num_bits_set,
    parse_freq,
    parse_len,
    strtod,
    strtol,
)
from dsp_tpu_torch.effects.base import EffectError


@dataclass
class FirConfig:
    do_align: bool = False
    offset: int = 0
    type: str | None = None
    enc: str | None = None
    endian: int = 0
    fs: int = 0  # 0 = "any"
    channels: int = 0
    extra: dict = field(default_factory=dict)


def parse_fir_opts(name, istream, opts, extra_handler=None):
    """Interpret getopt output for fir-family effects (fir_util.c:126-185)."""
    cfg = FirConfig(fs=istream.fs, channels=istream.channels)
    for opt, arg in opts:
        if opt == "a":
            cfg.do_align = True
            if arg is not None:
                try:
                    cfg.offset = parse_len(arg, istream.fs)
                except ParseError:
                    raise EffectError(f"{name}: failed to parse offset: {arg}")
        elif opt == "t":
            cfg.type = arg
        elif opt == "e":
            cfg.enc = arg
        elif opt == "B":
            cfg.endian = CODEC_ENDIAN_BIG
        elif opt == "L":
            cfg.endian = CODEC_ENDIAN_LITTLE
        elif opt == "N":
            cfg.endian = CODEC_ENDIAN_LITTLE
        elif opt == "r":
            if arg == "any":
                cfg.fs = 0
            else:
                try:
                    fs = int(round(parse_freq(arg)))
                except ParseError:
                    raise EffectError(f"{name}: failed to parse sample rate: {arg}")
                if fs <= 0:
                    raise EffectError(f"{name}: sample rate must be > 0")
                if fs != istream.fs:
                    raise EffectError(
                        f"{name}: sample rate mismatch: stream_fs={istream.fs} requested_fs={fs}"
                    )
                cfg.fs = fs
        elif opt == "c":
            v, rest = strtol(arg)
            if rest or v <= 0:
                raise EffectError(f"{name}: number of channels must be > 0")
            cfg.channels = v
        elif extra_handler is not None:
            extra_handler(opt, arg, cfg)
        else:
            raise EffectError(f"{name}: unrecognized option '{opt}'")
    return cfg


def read_filter(name, istream, selector, dir_, cfg, path):
    """Load filter data -> (data [frames, channels], channels, frames)."""
    if path.startswith("coefs:"):
        spec = path[len("coefs:") :]
        ch_lists = spec.split("/")
        frames = 1
        parsed = []
        for ch in ch_lists:
            coefs = []
            for c in ch.split(","):
                c = c.strip()
                if c == "":
                    coefs.append(0.0)
                else:
                    v, rest = strtod(c)
                    if rest == c or rest:
                        raise EffectError(f"{name}: failed to parse coefficient: {c}")
                    coefs.append(v)
            parsed.append(coefs)
            frames = max(frames, len(coefs))
        data = np.zeros((frames, len(parsed)), dtype=np.float64)
        for k, coefs in enumerate(parsed):
            data[: len(coefs), k] = coefs
        return data, len(parsed), frames
    if path.startswith("file:"):
        path = path[len("file:") :]
    fp = construct_full_path(dir_, path, istream.fs, num_bits_set(selector))
    p = CodecParams(
        path=fp,
        type=cfg.type,
        enc=cfg.enc,
        fs=cfg.fs if cfg.fs else istream.fs,
        channels=cfg.channels,
        endian=cfg.endian,
        mode=CODEC_MODE_READ,
    )
    try:
        c = init_codec(p)
    except CodecError as e:
        raise EffectError(f"{name}: failed to open filter file: {e}")
    log.verbose(
        "%s: input file: %s: type=%s enc=%s precision=%d channels=%d fs=%d",
        name, c.path, c.type, c.enc, c.prec, c.channels, c.fs,
    )
    if c.fs != istream.fs:
        if cfg.fs > 0:
            c.close()
            raise EffectError(f"{name}: sample rate mismatch: fs={istream.fs} filter_fs={c.fs}")
        log.verbose("%s: info: ignoring sample rate mismatch: fs=%d filter_fs=%d", name, istream.fs, c.fs)
    data = c.read(c.frames if c.frames > 0 else 1 << 24)
    c.close()
    if len(data) < 1:
        raise EffectError(f"{name}: empty filter file")
    return data, data.shape[1], len(data)


def filter_offset(cfg, data):
    """Alignment reference sample (fir_util.c:187-205). Mirrors the
    reference's flat (interleaved) peak index."""
    if not cfg.do_align:
        return 0
    if cfg.offset > 0:
        return cfg.offset
    if cfg.offset < 0:
        return len(data) + cfg.offset
    flat = np.asarray(data, dtype=np.float64).reshape(-1)
    peak = 0.0
    offset = 0
    for i, v in enumerate(flat):
        if v > peak:
            peak = v
            offset = i
    return offset
