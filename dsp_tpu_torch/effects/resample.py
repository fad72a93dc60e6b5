"""resample effect: high-quality sinc resampler, >230 dB SNR
(reference: resample.c).

Rate argument forms: ``fs[k]``, ``x{mult}``, ``/{div}``; optional bandwidth
0.7..0.999 (default 0.939). Ignores the channel selector.

The effect declares ``block_quantum = in_len`` so the chain sizes blocks to
whole inner resampler blocks; the filter's group delay is reported as
latency (consumed by the chain's output-side discard) instead of the
reference's internal first-block skip (resample.c:144-147): the same
observable stream, with fixed shapes. A block's inner blocks go through the
K8 step (ops/resample_ops.py) together: one launch where the resampler's
transforms are one pass each, else three.
"""

import math
from fractions import Fraction

import numpy as np

from dsp_tpu_torch.core import log
from dsp_tpu_torch.core.parse import ParseError, parse_freq, strtod, strtol
from dsp_tpu_torch.core.types import StreamInfo
from dsp_tpu_torch.effects.base import EFFECT_FLAG_CH_DEPS_IDENTITY, Effect, EffectError, register_effect
from dsp_tpu_torch.ops.resample_ops import SpectralResampler


class ResampleEffect(Effect):
    def __init__(self, name, istream, out_fs, bw):
        self.name = name
        self.istream = istream
        self.ostream = StreamInfo(out_fs, istream.channels)
        self.channel_selector = np.ones(istream.channels, dtype=bool)
        self.flags = EFFECT_FLAG_CH_DEPS_IDENTITY
        self.rs = SpectralResampler(istream.fs, out_fs, bw)
        self.ratio = Fraction(self.rs.n, self.rs.d)
        self.block_quantum = self.rs.in_len
        log.verbose(
            "%s: info: ratio=%d/%d width=%fHz fc=%f filter_len=%d in_len=%d out_len=%d sinc_oversample=%d",
            name, self.rs.n, self.rs.d, self.rs.width, self.rs.fc,
            self.rs.filter_len, self.rs.in_len, self.rs.out_len, self.rs.sinc_os,
        )

    def state0(self):
        return self.rs.state0(self.istream.channels)

    def split_lookback(self):
        # overlap-save memory: one input block plus the (oversampled-
        # domain, hence over-counted) prototype filter length
        return int(self.rs.in_len + self.rs.filter_len)

    def step(self, state, x):
        return self.rs.block(state, x)

    def channel_offsets(self):
        lat = np.full(self.ostream.channels, self.rs.out_delay, dtype=np.int64)
        return lat, np.zeros(self.ostream.channels, dtype=np.int64)

    def drain_samples(self, samples):
        # convert upstream tails to the output rate (ratio_mult_ceil,
        # effects_chain.c:909) and add the filter delay, which the chain's
        # output-side discard removes from the stream FRONT — the extra
        # out_delay tail frames keep the total at the reference's drain2
        # accounting (resample.c:170-176: out_delay + pending-output +
        # ceil(pending-input * ratio); pending terms are always complete in
        # the exact-block model, covered by the runner's ceil tail rule)
        n, d = self.rs.n, self.rs.d
        for o in range(self.ostream.channels):
            samples[o] = -(-samples[o] * n // d) + self.rs.out_delay


def resample_effect_init(ei, istream, selector, dir_, argv):
    name = argv[0]
    args = argv[1:]
    if not (1 <= len(args) <= 2):
        raise EffectError(f"{name}: usage: {ei.usage}")
    bw = 0.939
    if len(args) == 2:
        v, rest = strtod(args[0])
        if rest == args[0] or rest:
            raise EffectError(f"{name}: failed to parse bandwidth: {args[0]}")
        if not (0.7 <= v <= 0.999):
            raise EffectError(f"{name}: bandwidth out of range")
        bw = v
        rate_arg = args[1]
    else:
        rate_arg = args[0]
    if rate_arg.startswith("x"):
        v, rest = strtol(rate_arg[1:])
        if rest or v <= 0:
            raise EffectError(f"{name}: failed to parse fs multiplier: {rate_arg}")
        rate = istream.fs * v
    elif rate_arg.startswith("/"):
        v, rest = strtol(rate_arg[1:])
        if rest or v <= 0:
            raise EffectError(f"{name}: failed to parse fs divisor: {rate_arg}")
        if istream.fs % v != 0:
            raise EffectError(f"{name}: {v} is not a factor of {istream.fs}")
        rate = istream.fs // v
    else:
        try:
            rate = int(math.floor(parse_freq(rate_arg) + 0.5))  # lround, resample.c:249
        except ParseError:
            raise EffectError(f"{name}: failed to parse fs: {rate_arg}")
    if rate <= 0:
        raise EffectError(f"{name}: rate out of range")
    if rate == istream.fs:
        log.verbose("%s: info: sample rates match; no processing will be done", name)
        e = Effect()
        e.name = name
        e.istream = e.ostream = istream
        e.unused = True
        return [e]
    return ResampleEffect(name, istream, rate, bw)


register_effect("resample", "resample [bandwidth] fs[k]|x{mult}|/{div}", resample_effect_init)
