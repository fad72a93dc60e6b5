"""Time-reversed IIR filtering (the biquad family's -r option; reference:
reverse_iir.c, M. Vicanek, "A New Reverse IIR Filtering
Algorithm", 2015/2022).

A time-reversed (anticausal) IIR has response h[-n]; the reference
approximates each pole's anticausal exponential with a doubling cascade of
2^j-delay stages truncated at `thresh` dB relative to the slowest pole
(reverse_iir.c:92-139, 477-501). Here, as in dsp_tpu, the same
approximation class is reached directly: truncate the reversed impulse
response at the thresh-derived length N (N = ln(10^(-thresh/20)) / ln(max
pole radius), like the reference's stage-count choice) and run it as
zero-latency partitioned FFT convolution (UpolsConv, K6) with a requested
advance of N-1 samples, which the chain alignment pass distributes exactly
like the reference's negative channel_offsets (reverse_iir.c:250-255).

Cascaded time-reversed filters merge by composing their transfer functions
*before* truncation (one shared FIR, latency = max rather than sum),
mirroring the reference's parallel-structure merge (README.md:233-237).
"""

import numpy as np

from dsp_tpu_torch.core import log
from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_CH_DEPS_IDENTITY,
    EFFECT_FLAG_OPT_REORDERABLE,
    ChannelPick,
    Effect,
    EffectError,
)
from dsp_tpu_torch.ops.fft_conv import UpolsConv

MAX_N = 1 << 21


def _pole_min_stages(thresh_db, r):
    """RIIR_POLE_MIN_STAGES (reverse_iir.c:364): the doubling-cascade stage
    count covering the pole's tail down to (thresh + 6.02) dB:
    ceil(log2((thresh + 6.02) / (-20 log10 r)))."""
    if r >= 1.0:
        raise EffectError("reverse_iir: filter is unstable")
    if r <= 1e-12:
        return 0
    return max(0, int(np.ceil(np.log2((thresh_db + 6.02) / (-20.0 * np.log10(r))))))


def _section_stages(b, a, thresh_db):
    """Max stage count over a section's poles (reverse_iir.c:438-446)."""
    poles = np.roots(a) if len(a) > 1 else np.array([])
    n = 0
    for p in poles:
        n = max(n, _pole_min_stages(thresh_db, abs(p)))
    return n


def _reversed_impulse(b, a, n):
    from scipy.signal import lfilter

    x = np.zeros(n)
    x[0] = 1.0
    h = lfilter(b, a, x)
    return h[::-1].copy()


class ReverseIirEffect(Effect):
    """Anticausal IIR as an advanced FIR (per-channel cascades)."""

    def __init__(self, name, istream, selector, coeffs, thresh):
        """coeffs: (c0..c4) normalized biquad applied reversed on selected chs."""
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_OPT_REORDERABLE | EFFECT_FLAG_CH_DEPS_IDENTITY
        self.thresh = thresh
        n_ch = istream.channels
        # per-channel list of (b, a, thresh) sections — thresh is PER
        # SECTION, like the reference's riir_init_sec (reverse_iir.c:697):
        # merged cascaded -r filters keep their own truncation thresholds
        self.sections = [[] for _ in range(n_ch)]
        c0, c1, c2, c3, c4 = coeffs
        for k in range(n_ch):
            if self.channel_selector[k]:
                self.sections[k].append(
                    (np.array([c0, c1, c2]), np.array([1.0, c3, c4]), thresh)
                )
        self._built = False

    def merge(self, other):
        if type(other) is not type(self) or self._built:
            return False
        for k in range(self.istream.channels):
            self.sections[k].extend(other.sections[k])
        self.channel_selector |= other.channel_selector
        return True

    def prepare(self):
        if self._built:
            return
        self._built = True
        n_ch = self.istream.channels
        self.sel_idx = np.flatnonzero([bool(s) for s in self.sections])
        self._pick = ChannelPick(self.sel_idx, n_ch)
        irs = []
        adv = 1
        for k in self.sel_idx:
            b = np.array([1.0])
            a = np.array([1.0])
            n_stages = 0
            for bs, as_, th in self.sections[int(k)]:
                n_stages = max(n_stages, _section_stages(bs, as_, th))
                b = np.convolve(b, bs)
                a = np.convolve(a, as_)
            # the reference's latency per parallel structure is
            # (1 << N) + fir.n - 1 (reverse_iir.c:617-619) with fir.n the
            # polynomial-division remainder taps (1 for a biquad's equal
            # degrees); reproduce the same advance so cross-build output
            # timing matches exactly
            fir_n = max(len(b) - len(a), -1) + 1
            n2 = (1 << n_stages) + fir_n - 1
            n2 = min(max(n2, 1), MAX_N)
            adv = max(adv, n2)
            irs.append(_reversed_impulse(b, a, min(n2 + 1, MAX_N)))
        maxlen = adv + 1
        # right-align so every channel shares the same advance
        self.filters = np.zeros((len(self.sel_idx), maxlen))
        for i, ir in enumerate(irs):
            self.filters[i, maxlen - len(ir) :] = ir
        self.filter_frames = maxlen
        log.verbose("%s: info: reverse_iir length %d", self.name, maxlen)
        self._engines = {}

    def split_lookback(self):
        # truncated reversed IR (pure FIR) plus a bound on any residual
        return int(self.filters.shape[1]) + int(self.istream.fs)

    def _engine(self, B):
        eng = self._engines.get(B)
        if eng is None:
            eng = UpolsConv(self.filters, B)
            self._engines[B] = eng
        return eng

    def state_for_block(self, B):
        self.prepare()
        return self._engine(B).state0()

    def step(self, state, x):
        eng = self._engine(x.shape[-2])
        st, ys = eng.step(state, self._pick.take(x))
        return st, self._pick.put(x, ys)

    def channel_offsets(self):
        self.prepare()
        lat = np.zeros(self.ostream.channels, dtype=np.int64)
        req = np.zeros(self.ostream.channels, dtype=np.int64)
        req[self.sel_idx] = -(self.filter_frames - 1)
        return lat, req

    def drain_samples(self, samples):
        self.prepare()
        for k in self.sel_idx:
            samples[k] += self.filter_frames - 1

    def plot(self, idx, channel_offset=0):
        """Compact analytic form: the time-reversed filter's response is the
        conjugate of the forward response — each section contributes
        (b0 + b1 e^{+jw} + b2 e^{+2jw})/(a0 + a1 e^{+jw} + a2 e^{+2jw})
        (truncation sits at −(thresh+6) dB, invisible at plot resolution).
        O(sections) terms, like the reference's cascade product
        (reverse_iir.c:176-210) — NOT one term per FIR tap."""
        lines = []
        for k in range(self.ostream.channels):
            if self.sections[k]:
                facs = []
                for b, a, _th in self.sections[k]:
                    num = "+".join(
                        f"{b[j]:.15e}*exp(j*w*{j})" for j in range(len(b))
                    )
                    den = "+".join(
                        f"{a[j]:.15e}*exp(j*w*{j})" for j in range(len(a))
                    )
                    facs.append(f"(({num})/({den}))")
                lines.append(f"H{k}_{idx}(w)=" + "*".join(facs))
            else:
                lines.append(f"H{k}_{idx}(w)=1.0")
        return lines


def reverse_iir_from_biquad(name, istream, selector, coeffs, thresh):
    return ReverseIirEffect(name, istream, selector, coeffs, thresh)
