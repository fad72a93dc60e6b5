"""Interleaved sample format conversion (reference: sampleconv.h).

All conversions are vectorized numpy. The BIT_PERFECT convention matches the
reference default (dsp.h:36): integers scale by 2^(n-1), negative full scale
reaches -1.0 exactly, positive values clamp at +FS-1; rounding is nearbyint
(round-half-to-even, numpy's default). mu-law/a-law (G.711) are implemented
directly so wav/raw files using them don't require libsndfile.

Each encoding maps double <-> raw bytes; raw side is little-endian unless an
explicit endianness is requested by the codec.
"""

import numpy as np

# encoding -> (bytes_per_sample, precision_bits, can_dither)
ENCODINGS = {
    "u8": (1, 8, True),
    "s8": (1, 8, True),
    "s16": (2, 16, True),
    "s24": (4, 24, True),  # 24-bit in 32-bit container
    "s24_3": (3, 24, True),  # packed 3-byte
    "s32": (4, 32, True),
    "float": (4, 24, False),
    "double": (8, 53, False),
    "mu-law": (1, 13, False),
    "a-law": (1, 13, False),
}


def encoding_info(enc):
    if enc not in ENCODINGS:
        raise ValueError(f"unsupported encoding: {enc}")
    return ENCODINGS[enc]


def _clamp_int(x, scale):
    # BIT_PERFECT: scale by 2^(n-1); clamp only the positive side (sampleconv.h:36-40)
    y = np.rint(x * scale)
    return np.minimum(y, scale - 1)


def sample_to_raw(x, enc, endian="<"):
    """float64 array -> raw bytes in the given encoding."""
    x = np.asarray(x, dtype=np.float64)
    if enc == "u8":
        y = np.minimum(np.rint(x * 128.0 + 128.0), 255.0)
        return y.astype(np.uint8).tobytes()
    if enc == "s8":
        return _clamp_int(x, 128.0).astype(np.int8).tobytes()
    if enc == "s16":
        return _clamp_int(x, 32768.0).astype(np.dtype(endian + "i2")).tobytes()
    if enc == "s24":
        return _clamp_int(x, 8388608.0).astype(np.dtype(endian + "i4")).tobytes()
    if enc == "s24_3":
        v = _clamp_int(x, 8388608.0).astype(np.int32)
        b = v.astype(np.dtype("<i4")).view(np.uint8).reshape(-1, 4)
        out = b[:, :3] if endian == "<" else b[:, 2::-1]
        return np.ascontiguousarray(out).tobytes()
    if enc == "s32":
        return _clamp_int(x, 2147483648.0).astype(np.dtype(endian + "i4")).tobytes()
    if enc == "float":
        return x.astype(np.dtype(endian + "f4")).tobytes()
    if enc == "double":
        return x.astype(np.dtype(endian + "f8")).tobytes()
    if enc == "mu-law":
        return _linear_to_mulaw(x).tobytes()
    if enc == "a-law":
        return _linear_to_alaw(x).tobytes()
    raise ValueError(f"unsupported encoding: {enc}")


def raw_to_sample(data, enc, endian="<"):
    """Raw bytes -> float64 array."""
    if enc == "u8":
        v = np.frombuffer(data, dtype=np.uint8).astype(np.float64)
        return (v - 128.0) / 128.0
    if enc == "s8":
        return np.frombuffer(data, dtype=np.int8).astype(np.float64) / 128.0
    if enc == "s16":
        return np.frombuffer(data, dtype=np.dtype(endian + "i2")).astype(np.float64) / 32768.0
    if enc == "s24":
        v = np.frombuffer(data, dtype=np.dtype(endian + "i4"))
        # sign extend from bit 23 (sampleconv.h:33)
        v = (v.astype(np.int32) << 8) >> 8
        return v.astype(np.float64) / 8388608.0
    if enc == "s24_3":
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        if endian == "<":
            v = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
        else:
            v = (
                b[:, 2].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 0].astype(np.int32) << 16)
            )
        v = (v << 8) >> 8
        return v.astype(np.float64) / 8388608.0
    if enc == "s32":
        return np.frombuffer(data, dtype=np.dtype(endian + "i4")).astype(np.float64) / 2147483648.0
    if enc == "float":
        return np.frombuffer(data, dtype=np.dtype(endian + "f4")).astype(np.float64)
    if enc == "double":
        return np.frombuffer(data, dtype=np.dtype(endian + "f8")).astype(np.float64)
    if enc == "mu-law":
        return _mulaw_to_linear(np.frombuffer(data, dtype=np.uint8))
    if enc == "a-law":
        return _alaw_to_linear(np.frombuffer(data, dtype=np.uint8))
    raise ValueError(f"unsupported encoding: {enc}")


# --- G.711 mu-law / a-law ---

_MULAW_BIAS = 0x84


def _linear_to_mulaw(x):
    v = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int32)
    sign = np.where(v < 0, 0x80, 0)
    mag = np.minimum(np.abs(v), 32635) + _MULAW_BIAS
    exp = (np.floor(np.log2(mag)) - 7).astype(np.int32)
    exp = np.clip(exp, 0, 7)
    mant = (mag >> (exp + 3)) & 0x0F
    return (~(sign | (exp << 4) | mant)).astype(np.uint8)


def _mulaw_to_linear(u):
    u = (~u.astype(np.int32)) & 0xFF
    sign = u & 0x80
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = ((mant << 3) + _MULAW_BIAS) << exp
    mag = mag - _MULAW_BIAS
    v = np.where(sign != 0, -mag, mag)
    return v.astype(np.float64) / 32768.0


def _linear_to_alaw(x):
    v = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int32)
    sign = np.where(v >= 0, 0x80, 0)
    mag = np.minimum(np.abs(v), 32767) >> 3  # 13-bit magnitude
    exp = np.zeros_like(mag)
    m = mag.copy()
    for e in range(1, 8):
        exp = np.where(m >= (1 << (e + 4)), e, exp)
    mant = np.where(exp == 0, (mag >> 1) & 0x0F, (mag >> exp) & 0x0F)
    return ((sign | (exp << 4) | mant) ^ 0x55).astype(np.uint8)


def _alaw_to_linear(a):
    a = a.astype(np.int32) ^ 0x55
    sign = a & 0x80
    exp = (a >> 4) & 0x07
    mant = a & 0x0F
    mag = np.where(exp == 0, (mant << 1) + 1, ((mant << 1) + 1 + 32) << (exp - 1))
    mag = mag << 3
    v = np.where(sign != 0, mag, -mag)
    return v.astype(np.float64) / 32768.0
