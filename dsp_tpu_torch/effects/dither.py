"""dither effect: TPDF dither with optional noise shaping (reference:
dither.c).

Shapes: flat (no feedback), sloped (1st-order HP feedback), sloped2 (sloped
TPDF + feedback), lipshitz (5-tap E-weighted), wan3/wan9 (F-weighted,
44.1/48k family only). The block runs on the K15 kernel
(ops/time_domain.tpdf_dither): the TPDF noise for the whole block from
dsp_tpu's threefry stream, then the quantizer, flat or inside the
sample-serial error-feedback loop (dither.c:146-170). 'auto' bits track the
output codec precision via set_auto_params, driven by the application's
SHOULD_DITHER policy (dsp.c:46-48,872-879).
"""

import numpy as np
import torch

from dsp_tpu_torch.core import log
from dsp_tpu_torch.core.parse import strtod
from dsp_tpu_torch.core.prng import PM_RAND_MAX, prng_key
from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_CH_DEPS_IDENTITY,
    Effect,
    EffectError,
    register_effect,
)
from dsp_tpu_torch.ops import time_domain

_FILTERS = {
    "lipshitz": np.array([2.033, -2.165, 1.959, -1.590, 0.6149]),
    "wan3": np.array([1.623, -0.982, 0.109]),
    "wan9": np.array([2.412, -3.370, 3.937, -4.174, 3.353, -2.205, 1.281, -0.569, 0.0847]),
}
# (type, restricted_fs): fs=0 means any rate (dither.c:66-72)
_TYPES = {
    "flat": 0,
    "sloped": 0,
    "sloped2": 0,
    "lipshitz": 44100,
    "wan3": 46000,
    "wan9": 46000,
}


class DitherEffect(Effect):
    split_safe = False  # PRNG stream: segments would replay the sequence

    def __init__(self, name, istream, selector, shape, noise_bits, quantize_bits,
                 noise_auto, quantize_auto, seed=0):
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_CH_DEPS_IDENTITY
        self.shape = shape
        self.seed = seed
        n = istream.channels
        # per-channel parameters so merged effects with different configs coexist
        self.enabled = self.channel_selector.copy()
        self.n_mult = np.zeros(n)
        self.q_mult0 = np.ones(n)
        self.q_mult1 = np.ones(n)
        self.noise_auto = self.channel_selector & noise_auto
        self.quantize_auto = self.channel_selector & quantize_auto
        if not noise_auto and np.isfinite(noise_bits):
            self._set_noise_bits(self.channel_selector, noise_bits)
        if not quantize_auto and quantize_bits:
            self._set_quantize_bits(self.channel_selector, quantize_bits)
        if noise_auto:
            self.enabled &= False  # until set_auto_params
        self.fir = np.zeros(time_domain.DITHER_TAPS)
        if shape in ("sloped", "sloped2"):
            self.fir[0] = 1.0
        elif shape in _FILTERS:
            self.fir[: len(_FILTERS[shape])] = _FILTERS[shape]
        self.mode = {"flat": time_domain.DITHER_FLAT,
                     "sloped2": time_domain.DITHER_SLOPED2}.get(shape, time_domain.DITHER_SHAPED)

    def _set_noise_bits(self, mask, bits):
        self.n_mult = np.where(mask, 2.0 / (2.0**bits) / PM_RAND_MAX, self.n_mult)

    def _set_quantize_bits(self, mask, bits):
        bits = max(min(int(bits), 32), 2)
        q = float(1 << (bits - 1))
        self.q_mult0 = np.where(mask, q, self.q_mult0)
        self.q_mult1 = np.where(mask, 1.0 / q, self.q_mult1)

    def set_auto_params(self, bits, enabled):
        """Track output codec precision (dither.c:262-280)."""
        na = self.noise_auto
        if na.any():
            if not enabled or bits < 2 or bits > 32:
                self.enabled &= ~na
            else:
                self._set_noise_bits(na, float(bits))
                self.enabled |= na
        qa = self.quantize_auto
        if qa.any():
            self._set_quantize_bits(qa, 32 if bits < 2 else bits)

    @property
    def is_dither(self):
        return True

    def state0(self):
        # the same draw as dsp_tpu's, so a seeded numpy gives both the same key
        key = prng_key(self.seed if self.seed else np.random.randint(1 << 30)).numpy()
        n = self.istream.channels
        # feedback error history (max 9 taps) + previous-noise carry for sloped2
        return {
            "key": key,
            "ehist": np.zeros((time_domain.DITHER_TAPS, n), dtype=np.float64),
            "nprev": np.zeros((n,), dtype=np.float64),
        }

    def step(self, state, x):
        key, ehist, nprev, y = time_domain.tpdf_dither(
            state["key"], x, state["ehist"], state["nprev"],
            self.device_array("n_mult", x), self.device_array("q_mult0", x),
            self.device_array("q_mult1", x), self.device_array("enabled", x, torch.bool),
            self.device_array("fir", x), self.mode,
        )
        return {"key": key, "ehist": ehist, "nprev": nprev}, y

    def merge(self, other):
        if type(other) is not type(self):
            return False
        if (other.channel_selector & self.channel_selector).any():
            return False
        if other.shape != self.shape:
            return False  # per-channel shapes would need distinct feedback paths
        sel = other.channel_selector
        self.channel_selector |= sel
        self.enabled = np.where(sel, other.enabled, self.enabled)
        self.n_mult = np.where(sel, other.n_mult, self.n_mult)
        self.q_mult0 = np.where(sel, other.q_mult0, self.q_mult0)
        self.q_mult1 = np.where(sel, other.q_mult1, self.q_mult1)
        self.noise_auto |= other.noise_auto
        self.quantize_auto |= other.quantize_auto
        return True


def dither_effect_init(ei, istream, selector, dir_, argv):
    name = argv[0]
    args = argv[1:]
    if len(args) > 3:
        raise EffectError(f"{name}: usage: {ei.usage}")
    # slot dispatch mirrors dither.c:299-314: the shape slot is chosen by a
    # RATE-IGNORANT name lookup; with all three args the first is the shape
    # slot unconditionally
    shape_word = noise_bits = quantize_bits = None
    if len(args) == 1:
        if args[0] in _TYPES:
            shape_word = args[0]
        else:
            noise_bits = args[0]
    elif len(args) == 2:
        if args[0] in _TYPES:
            shape_word = args[0]
        else:
            quantize_bits = args[0]
        noise_bits = args[1]
    elif len(args) == 3:
        shape_word, quantize_bits, noise_bits = args

    shape = "flat"
    if shape_word is not None:
        fs_req = _TYPES.get(shape_word)
        if fs_req is not None and (
            not fs_req or abs(fs_req - istream.fs) < fs_req * 0.05
        ):
            shape = shape_word
        else:
            # unknown word in the shape slot, or a rate-gated shape at the
            # wrong fs: the reference WARNS and falls back to sloped
            # (dither.c:317-323) — existing chains must keep running
            log.error(
                "%s: warning: invalid shape for fs=%d: %s",
                name, istream.fs, shape_word,
            )
            shape = "sloped"

    noise_auto = noise_bits is None or noise_bits == "auto"
    nb = np.inf
    if not noise_auto:
        nb, rest = strtod(noise_bits)
        if rest == noise_bits or rest:
            raise EffectError(f"{name}: failed to parse bits: {noise_bits}")
        if not np.isfinite(nb):
            # dither.c:338-342: isfinite check, clean error
            raise EffectError(f"{name}: bits is invalid: {nb:g}")
    quantize_auto = quantize_bits is None or quantize_bits == "auto"
    qb = 0
    if not quantize_auto:
        qv, rest = strtod(quantize_bits)
        if rest == quantize_bits or rest:
            raise EffectError(f"{name}: failed to parse quantize_bits: {quantize_bits}")
        qb = int(round(qv))
        if not (2 <= qb <= 32):
            raise EffectError(f"{name}: quantize_bits out of range")
    elif not noise_auto:
        # quantize_bits defaults to bits rounded (README dither notes)
        quantize_auto = False
        qb = max(min(int(round(nb)), 32), 2)

    return DitherEffect(name, istream, selector, shape, nb, qb, noise_auto, quantize_auto)


register_effect("dither", "dither [shape] [[quantize_bits] bits]", dither_effect_init)
