"""decorrelate effect: frequency-dependent Schroeder allpass decorrelator
(Schlecht, doi:10.3390/app10010187; reference: decorrelate.c).

Each stage is a delay-embedded first-order-shelf allpass

    H(z) = (b1 + b0 z^-1 + a1 z^-(L-1) + z^-L) / (1 + a1 z^-1 + b0 z^-(L-1) + b1 z^-L)

with per-channel random delays L-1 in [delay_min, delay_max] drawn from the
reference's Park-Miller stream (exact sequence, so -s seeds match) and shelf
coefficients from fc / RT60_lf / RT60_hf (decorrelate.c:44-62).

Design (dsp_tpu's): the cascade is LTI with an exponentially decaying
response (RT60-bounded), so the exact per-channel impulse response is
computed at init with scipy.signal.lfilter and truncated far below the noise
floor, then run as zero-latency partitioned FFT convolution (UpolsConv, K6)
— no per-sample ring buffers on the device.
"""

import numpy as np

from dsp_tpu_torch.core import log
from dsp_tpu_torch.core.parse import ParseError, getopt, parse_freq, parse_len, parse_len_frac, strtol
from dsp_tpu_torch.core.prng import PM_RAND_MAX, PmRand
from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_CH_DEPS_IDENTITY,
    EFFECT_FLAG_OPT_REORDERABLE,
    ChannelPick,
    Effect,
    EffectError,
    register_effect,
)
from dsp_tpu_torch.ops.fft_conv import UpolsConv

# shared Park-Miller stream across instances (decorrelate.c:149-150)
_GLOBAL_SEED = PmRand(48271, 1)

TRUNC_DB = 200.0  # truncate the impulse response this far below peak


def sch_ap_coeffs(fs, delay_samples, fc, rt60_lf, rt60_hf):
    """Shelf-allpass numerator/denominator (decorrelate.c:44-62)."""
    gain_lf = -60.0 / (rt60_lf * fs) * delay_samples
    gain_hf = -60.0 / (rt60_hf * fs) * delay_samples
    w0 = 2.0 * np.pi * fc / fs
    t = np.tan(w0 / 2.0)
    g_hf = 10.0 ** (gain_hf / 20.0)
    gd = 10.0 ** ((gain_lf - gain_hf) / 20.0)
    sgd = np.sqrt(gd)
    a0 = t + sgd
    a1 = (t - sgd) / a0
    b0 = (gd * t - sgd) / a0 * g_hf
    b1 = (gd * t + sgd) / a0 * g_hf
    L = delay_samples + 1
    num = np.zeros(L + 1)
    den = np.zeros(L + 1)
    num[0] = b1
    num[1] = b0
    num[L - 1] += a1
    num[L] += 1.0
    den[0] = 1.0
    den[1] = a1
    den[L - 1] += b0
    den[L] += b1
    return num, den, (b0, b1, a1, L)


class DecorrelateEffect(Effect):
    def __init__(self, name, istream, selector, stage_coeffs, ir_len):
        """stage_coeffs: {channel: [(num, den, meta), ...]}."""
        from scipy.signal import lfilter

        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_OPT_REORDERABLE | EFFECT_FLAG_CH_DEPS_IDENTITY
        self.sel_idx = np.flatnonzero(self.channel_selector)
        self._pick = ChannelPick(self.sel_idx, istream.channels)
        self.stage_coeffs = stage_coeffs
        irs = []
        max_len = 1
        for k in self.sel_idx:
            x = np.zeros(ir_len)
            x[0] = 1.0
            for num, den, _ in stage_coeffs[int(k)]:
                x = lfilter(num, den, x)
            # truncate below the noise floor
            thresh = np.abs(x).max() * 10.0 ** (-TRUNC_DB / 20.0)
            nz = np.flatnonzero(np.abs(x) > thresh)
            n = int(nz[-1]) + 1 if len(nz) else 1
            irs.append(x[:n])
            max_len = max(max_len, n)
        self.filters = np.zeros((len(self.sel_idx), max_len))
        for i, ir in enumerate(irs):
            self.filters[i, : len(ir)] = ir
        self.filter_frames = max_len
        log.verbose("%s: info: impulse response length %d", name, max_len)
        self._engines = {}

    def split_lookback(self):
        return int(self.filters.shape[1])

    def _engine(self, B):
        eng = self._engines.get(B)
        if eng is None:
            eng = UpolsConv(self.filters, B)
            self._engines[B] = eng
        return eng

    def state_for_block(self, B):
        return self._engine(B).state0()

    def step(self, state, x):
        eng = self._engine(x.shape[-2])
        st, ys = eng.step(state, self._pick.take(x))
        return st, self._pick.put(x, ys)

    # NOTE: no drain_samples — the reference's decorrelate is an IIR allpass
    # network with no drain hook (decorrelate.c): output frame count equals
    # input frame count and the decaying tail is cut, even though our FIR
    # realization could flush it. Parity over completeness.

    def plot(self, idx, channel_offset=0):
        lines = []
        sel = set(int(k) for k in self.sel_idx)
        for k in range(self.ostream.channels):
            if k in sel:
                terms = []
                for num, den, (b0, b1, a1, L) in self.stage_coeffs[k]:
                    terms.append(
                        f"(({b1:.15e}+{b0:.15e}*exp(-j*w)+{a1:.15e}*exp(-j*w*{L - 1})"
                        f"+{1.0:.15e}*exp(-j*w*{L}))/(1.0+{a1:.15e}*exp(-j*w)"
                        f"+{b0:.15e}*exp(-j*w*{L - 1})+{b1:.15e}*exp(-j*w*{L})))"
                    )
                lines.append(f"H{k}_{idx}(w)=(abs(w)<=pi)?1.0*" + "*".join(terms) + ":0/0")
            else:
                lines.append(f"H{k}_{idx}(w)=1.0")
        return lines


def decorrelate_effect_init(ei, istream, selector, dir_, argv):
    global _GLOBAL_SEED
    name = argv[0]
    try:
        opts, ind = getopt(argv[1:], "ms:d:D:f:l:h:")
    except ParseError as e:
        raise EffectError(f"{name}: {e}")
    mono = False
    n_stages = 5
    opt_seed = None
    fs = istream.fs
    delay_min = int(round(0.83333e-3 * fs))
    delay_max = int(round(3.12503e-3 * fs))
    fc = 1100.0
    rt60_lf, rt60_hf = 0.1, 0.008
    for opt, arg in opts:
        if opt == "m":
            mono = True
        elif opt == "s":
            v, rest = strtol(arg)
            if rest or not (0 < v <= PM_RAND_MAX):
                raise EffectError(f"{name}: seed out of range")
            _GLOBAL_SEED = PmRand(48271, v)
        elif opt == "d":
            try:
                delay_min = parse_len(arg, fs)
            except ParseError:
                raise EffectError(f"{name}: failed to parse delay_min: {arg}")
            if not (0 < delay_min <= fs * 2):
                raise EffectError(f"{name}: delay_min out of range")
        elif opt == "D":
            try:
                delay_max = parse_len(arg, fs)
            except ParseError:
                raise EffectError(f"{name}: failed to parse delay_max: {arg}")
            if not (0 < delay_max <= fs * 2):
                raise EffectError(f"{name}: delay_max out of range")
        elif opt == "f":
            try:
                fc = parse_freq(arg)
            except ParseError:
                raise EffectError(f"{name}: failed to parse fc: {arg}")
            if not (0.0 <= fc < fs / 2.0):
                raise EffectError(f"{name}: fc out of range")
        elif opt == "l":
            try:
                rt60_lf = parse_len_frac(arg, fs) / fs
            except ParseError:
                raise EffectError(f"{name}: failed to parse rt60_lf: {arg}")
            if rt60_lf <= 0:
                raise EffectError(f"{name}: rt60_lf out of range")
        elif opt == "h":
            try:
                rt60_hf = parse_len_frac(arg, fs) / fs
            except ParseError:
                raise EffectError(f"{name}: failed to parse rt60_hf: {arg}")
            if rt60_hf <= 0:
                raise EffectError(f"{name}: rt60_hf out of range")
    args = argv[1 + ind :]
    if delay_max <= delay_min:
        raise EffectError(f"{name}: delay_max must be greater than delay_min")
    if len(args) > 1:
        raise EffectError(f"{name}: usage: {ei.usage}")
    if len(args) == 1:
        v, rest = strtol(args[0])
        if rest or not (0 < v <= 100):
            raise EffectError(f"{name}: stages out of range")
        n_stages = v

    def rand_delay():
        # lround like the C (decorrelate.c:145): half away from zero, not
        # Python's banker's rounding — a .5 tie would change the delay and
        # thus the whole filter for the same seed
        import math

        return int(math.floor(
            _GLOBAL_SEED.next() / PM_RAND_MAX * (delay_max - delay_min) + delay_min + 0.5
        ))

    sel = np.asarray(selector, dtype=bool)
    stage_coeffs = {int(k): [] for k in np.flatnonzero(sel)}
    for j in range(n_stages):
        d_mono = rand_delay() if mono else None
        for k in np.flatnonzero(sel):
            d = d_mono if mono else rand_delay()
            stage_coeffs[int(k)].append(sch_ap_coeffs(fs, d, fc, rt60_lf, rt60_hf))
    ir_len = int(fs * rt60_lf * (TRUNC_DB / 60.0 + 1.0)) + delay_max * n_stages + 1
    return DecorrelateEffect(name, istream, sel, stage_coeffs, ir_len)


register_effect(
    "decorrelate",
    "decorrelate [options] [stages]",
    decorrelate_effect_init,
)
