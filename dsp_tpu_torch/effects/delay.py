"""delay effect: integer, fractional (Thiran), and modulated delay lines
(reference: delay.c, allpass.c/h).

* Integer delay is free at runtime: it becomes a requested delay consumed by
  the chain's alignment pass (delay.c:142-147, channel_offsets) — the effect
  itself is a runtime no-op.
* Fractional delay uses Thiran maximally-flat allpass interpolation of order
  1..50. The reference runs a ladder realization (Koshita 2014,
  allpass.h:71-108); here, as in dsp_tpu, the same transfer function is
  computed from the closed-form Thiran denominator and factored into
  cascaded allpass biquad sections, each run on the K2 kernel
  (ops/iir.biquad_scan).
* Random modulation (-m/-M) reads the delay line at a noise-driven position:
  approximately Gaussian noise (sum of 6 TPDF values, from dsp_tpu's
  threefry stream) through a cubic B-spline at bandwidth fc drives an
  interpolated read (cubic Hermite, or 6x/16x polyphase FIR + cubic
  B-spline), on the K14 kernel (ops/time_domain.mod_delay). The polyphase
  tables are regenerated from their published design (Dolph-Chebyshev
  windowed sinc) rather than copied.
"""

from math import comb

import numpy as np
import torch

from dsp_tpu_torch.core.parse import ParseError, getopt, parse_freq, parse_len_frac, strtod, strtol
from dsp_tpu_torch.core.prng import prng_key
from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_CH_DEPS_IDENTITY,
    EFFECT_FLAG_OPT_REORDERABLE,
    Effect,
    EffectError,
    register_effect,
)
from dsp_tpu_torch.ops import iir, time_domain

DELAY_MIN_FRAC = 0.1
FD_AP_N_DEFAULT = 2
MOD_BW_DEFAULT = 1.0


def thiran_denominator(n, d):
    """Closed-form Thiran allpass denominator a[0..n] for delay d (> n-1)."""
    a = np.zeros(n + 1)
    for k in range(n + 1):
        prod = 1.0
        for i in range(n + 1):
            prod *= (d - n + i) / (d - n + k + i)
        a[k] = ((-1) ** k) * comb(n, k) * prod
    return a


def allpass_sections(a):
    """Factor an allpass with denominator a (a[0]=1) into 2nd/1st-order
    allpass sections. Returns [S, 5] normalized biquad coefficient rows."""
    n = len(a) - 1
    if n == 0:
        return np.zeros((0, 5))
    poles = np.roots(a)
    # group complex-conjugate pairs and real poles
    used = np.zeros(len(poles), dtype=bool)
    sections = []
    reals = []
    for i, p in enumerate(poles):
        if used[i]:
            continue
        if abs(p.imag) > 1e-12:
            # find conjugate
            for j in range(i + 1, len(poles)):
                if not used[j] and abs(poles[j] - np.conj(p)) < 1e-8:
                    used[i] = used[j] = True
                    a1 = -2.0 * p.real
                    a2 = abs(p) ** 2
                    sections.append([a2, a1, 1.0, a1, a2])
                    break
            else:
                raise EffectError("thiran: unpaired complex pole")
        else:
            used[i] = True
            reals.append(p.real)
    while len(reals) >= 2:
        p1, p2 = reals.pop(), reals.pop()
        a1 = -(p1 + p2)
        a2 = p1 * p2
        sections.append([a2, a1, 1.0, a1, a2])
    if reals:
        p = reals.pop()
        sections.append([-p, 1.0, 0.0, -p, 0.0])
    return np.array(sections)


class DelayEffect(Effect):
    """Integer + fractional delay. Integer part feeds the alignment pass."""

    def __init__(self, name, istream, selector, samples_int, samples_frac, fd_ap_n):
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_OPT_REORDERABLE | EFFECT_FLAG_CH_DEPS_IDENTITY
        self.samples_int = np.where(self.channel_selector, samples_int, 0).astype(np.int64)
        self.samples_frac = np.where(self.channel_selector, samples_frac, 0.0)
        self.fd_ap_n = np.where(self.channel_selector, fd_ap_n, 0).astype(np.int64)
        self._sections = None  # [S, 5, C] after prepare
        self._prepared = False

    def merge(self, other):
        if type(other) is not type(self) or self._prepared:
            return False
        self.samples_int = self.samples_int + other.samples_int
        self.samples_frac = self.samples_frac + other.samples_frac
        self.fd_ap_n = np.maximum(self.fd_ap_n, other.fd_ap_n)
        return True

    def prepare(self):
        """Split fractional parts; build Thiran sections (delay.c:149-205)."""
        if self._prepared:
            return
        self._prepared = True
        n_ch = self.istream.channels
        fd_n = self.fd_ap_n.copy()
        for k in range(n_ch):
            if fd_n[k] < 1:
                fd_n[k] = FD_AP_N_DEFAULT
            frac = self.samples_frac[k]
            if abs(frac - np.rint(frac)) >= np.finfo(np.float64).eps:
                adj = (fd_n[k] - 1) - int(np.floor(frac - DELAY_MIN_FRAC))
                self.samples_int[k] -= adj
                self.samples_frac[k] = frac + adj
            else:
                self.samples_int[k] += int(np.rint(frac))
                self.samples_frac[k] = 0.0
                fd_n[k] = 0
        self.fd_ap_n = fd_n
        max_s = 0
        per_ch = []
        for k in range(n_ch):
            if fd_n[k] > 0:
                delta = abs(self.samples_frac[k])
                a = thiran_denominator(int(fd_n[k]), delta)
                secs = allpass_sections(a)
            else:
                secs = np.zeros((0, 5))
            per_ch.append(secs)
            max_s = max(max_s, len(secs))
        if max_s == 0:
            self.runtime_noop = True
            self._sections = None
            return
        S = max_s
        sections = np.zeros((S, 5, n_ch))
        sections[:, 0, :] = 1.0  # identity
        for k, secs in enumerate(per_ch):
            for s in range(len(secs)):
                sections[s, :, k] = secs[s]
        self._sections = sections
        # each section's state-space form for K2 ([S, C, 2, 2], [S, C, 2], [S, C])
        ss = [iir.biquad_coeffs_to_ss(sections[s]) for s in range(S)]
        self._ss_A, self._ss_Bv, self._ss_c0 = (np.stack(t) for t in zip(*ss))
        # under float32, dsp_tpu casts each section's coefficients to float32
        # before the state-space form and scans in float32 (K2 in float32)
        ss = [iir.biquad_coeffs_to_ss(sections[s], np.float32) for s in range(S)]
        self._ss32_A, self._ss32_Bv, self._ss32_c0 = (np.stack(t) for t in zip(*ss))

    def state0(self):
        if self._sections is None:
            return ()
        S = self._sections.shape[0]
        return np.zeros((S, self.istream.channels, 2), dtype=np.float64)

    def step(self, state, x):
        if self._sections is None:
            return state, x
        ss = "_ss32" if x.dtype == torch.float32 else "_ss"
        A, Bv, c0 = (self.device_array(ss + k, x) for k in ("_A", "_Bv", "_c0"))
        new_states = []
        for s in range(self._sections.shape[0]):
            # section s's [C, 2] state ([S, C, 2] with a stream axis)
            st, x = iir.biquad_scan(A[s], Bv[s], c0[s], state.select(-3, s).contiguous(), x)
            new_states.append(st)
        return torch.stack(new_states, dim=-3), x

    def channel_offsets(self):
        lat = np.zeros(self.ostream.channels, dtype=np.int64)
        return lat, self.samples_int.copy()

    def split_lookback(self):
        # delay-line memory plus the Thiran allpass tail (fast pole)
        return int(self.samples_int.max(initial=0)) + 4096

    def drain_samples(self, samples):
        for k in range(self.istream.channels):
            samples[k] += int(self.fd_ap_n[k])

    def plot(self, idx, channel_offset=0):
        """Emit the reference's exact expressions (delay.c:84-104): ap1/ap2
        closed forms for orders 1-2 and the Koshita ladder continued fraction
        (allpass.c:39-48) for order n — the runtime realizes the same Thiran
        transfer function as a biquad cascade, but the plot string must match
        byte-for-byte."""
        lines = []
        for k in range(self.ostream.channels):
            h = f"H{k}_{idx}(w)=exp(-j*w*{int(self.samples_int[k])})"
            n = int(self.fd_ap_n[k])
            if n > 0 and self.samples_frac[k] != 0.0:
                delta = abs(float(self.samples_frac[k]))
                if n == 1:
                    c0 = (1.0 - delta) / (1.0 + delta)
                    h += (
                        f"*((abs(w)<=pi)?({c0:.15e}+1.0*exp(-j*w))"
                        f"/(1.0+{c0:.15e}*exp(-j*w)):0/0)"
                    )
                elif n == 2:
                    c0 = (4.0 - 2.0 * delta) / (1.0 + delta)
                    c1 = ((delta - 2.0) * (delta - 1.0)) / ((delta + 1.0) * (delta + 2.0))
                    h += (
                        f"*((abs(w)<=pi)?({c1:.15e}+{c0:.15e}*exp(-j*w)+exp(-2*j*w))"
                        f"/(1.0+{c0:.15e}*exp(-j*w)+{c1:.15e}*exp(-2*j*w)):0/0)"
                    )
                else:
                    h += "*((abs(w)<=pi)?(1.0"
                    for j in range(n):
                        lc0 = delta - j
                        inv_c1 = -(delta + (j + 1))
                        lc2 = 2 * j + 1
                        h += (
                            f"+{lc0:.15e}/({-float(lc2):.15e}"
                            f"*(exp(-j*w)/(1.0-exp(-j*w)))+{inv_c1:.15e}/(2.0"
                        )
                    h += "))" * n
                    h += "):0/0)"
            lines.append(h)
        return lines


def _make_polyphase_table(n_phases, taps, fc, stop_db):
    """Regenerate the modulated-delay interpolation filters: windowed-sinc
    (Dolph-Chebyshev window) polyphase decimation of an oversampling lowpass
    (cf. delay.c tables: q1 = 6 phase x 16 taps fc=0.91/76dB, q2 = 16 x 32
    fc=0.936/120dB)."""
    from scipy.signal.windows import chebwin

    N = n_phases * taps
    t = np.arange(N) - (N - 1) / 2.0
    h = fc * np.sinc(fc * t / n_phases) * chebwin(N, at=stop_db)
    # normalize for unity DC gain per phase
    table = np.zeros((n_phases, taps))
    for ph in range(n_phases):
        row = h[ph::n_phases][::-1]
        table[ph] = row / row.sum()
    return table


class ModDelayEffect(Effect):
    """Randomly modulated delay line (-m/-M options of delay)."""

    split_safe = False  # PRNG-driven modulator: segments would replay it

    def plot(self, idx, channel_offset=0):
        # the modulator list-member uses effect_plot_noop (delay.c:651)
        return [f"H{k}_{idx}(f)=1.0" for k in range(self.ostream.channels)]

    def __init__(self, name, istream, selector, samples, fc, is_mono, qual, seed=None):
        if qual not in (0, 1, 2):
            raise EffectError(f"{name}: invalid quality: {qual}")
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_CH_DEPS_IDENTITY
        self.qual = qual
        self.n_taps = {0: 3, 1: 16, 2: 32}[qual]
        self.n_phases = {0: 0, 1: 6, 2: 16}[qual]
        if qual == 1:
            self.table = _make_polyphase_table(6, 16, 0.91, 76)
        elif qual == 2:
            self.table = _make_polyphase_table(16, 32, 0.936, 120)
        else:
            self.table = None
        self.len = int(np.rint(np.ceil(samples))) * 2 + self.n_taps
        self.depth = samples * 2.0
        self.step_size = 2.0 * fc / istream.fs
        self.is_mono = is_mono
        # drawn here, at init, as dsp_tpu draws it
        self.seed = seed if seed is not None else np.random.randint(1 << 30)

    def state0(self):
        n = self.istream.channels
        H = self.len + self.n_taps
        return {
            "buf": np.zeros((H, n), dtype=np.float64),
            "key": prng_key(self.seed).numpy(),
            # B-spline knot window [4, lanes] and phase accumulator
            "y": np.zeros((4, 1 if self.is_mono else n), dtype=np.float64),
            "t": np.zeros((), dtype=np.float64),
        }

    def step(self, state, x):
        table = None if self.table is None else self.device_array("table", x)
        # one call: the read, the knots and the line's last H rows of [buf | x]
        key, yk, t, y, buf = time_domain.mod_delay(
            state["key"], state["y"], state["t"], state["buf"], x,
            self.device_array("channel_selector", x, torch.bool), table,
            self.depth, self.step_size, self.n_taps, self.qual,
        )
        return {"buf": buf, "key": key, "t": t, "y": yk}, y

    def channel_offsets(self):
        lat = np.where(self.channel_selector, self.len // 2, 0).astype(np.int64)
        return lat, np.zeros(self.ostream.channels, dtype=np.int64)

    def drain_samples(self, samples):
        for k in range(self.istream.channels):
            if self.channel_selector[k]:
                samples[k] += self.len


def delay_effect_init(ei, istream, selector, dir_, argv):
    name = argv[0]
    args = argv[1:]
    if not args:
        raise EffectError(f"{name}: usage: {ei.usage}")
    # last argument is the delay operand; options before it (dsp_getopt with
    # argc-1, delay.c:694)
    try:
        opts, ind = getopt(args[:-1], "f::m:M:b:q:")
    except ParseError as e:
        raise EffectError(f"{name}: {e}")
    if ind != len(args) - 1:
        raise EffectError(f"{name}: usage: {ei.usage}")
    do_frac = False
    fd_ap_n = 0
    mod_arg = None
    mod_mono = False
    mod_qual = 1
    mod_bw = MOD_BW_DEFAULT
    for opt, arg in opts:
        if opt == "f":
            do_frac = True
            if arg is not None:
                v, rest = strtol(arg)
                if rest or not (0 < v <= 50):
                    raise EffectError(f"{name}: order out of range")
                fd_ap_n = v
        elif opt in ("m", "M"):
            mod_arg = arg
            mod_mono = opt == "M"
        elif opt == "b":
            try:
                mod_bw = parse_freq(arg)
            except ParseError:
                raise EffectError(f"{name}: failed to parse modulation bandwidth: {arg}")
            if not (0.0 < mod_bw < istream.fs / 2.0):
                raise EffectError(f"{name}: modulation bandwidth out of range")
        elif opt == "q":
            v, rest = strtol(arg)
            if rest:
                raise EffectError(f"{name}: failed to parse quality: {arg}")
            mod_qual = v
    try:
        samples = parse_len_frac(args[-1], istream.fs)
    except ParseError:
        raise EffectError(f"{name}: failed to parse delay: {args[-1]}")

    mod_samples = 0.0
    if mod_arg is not None:
        v, rest = strtod(mod_arg)
        if rest == "%":
            # a bare '%' parses as 0% (strtod consumed nothing, v == 0) —
            # the reference accepts it as no modulation (delay.c:733-740)
            mod_samples = samples * (v / 100.0)
        else:
            try:
                mod_samples = parse_len_frac(mod_arg, istream.fs)
            except ParseError:
                raise EffectError(f"{name}: failed to parse modulation depth: {mod_arg}")

    effects = []
    if do_frac:
        e = DelayEffect(name, istream, selector, 0, samples, fd_ap_n)
    else:
        samples_int = int(np.rint(samples))
        e = DelayEffect(name, istream, selector, samples_int, 0.0, 0)
    if e.samples_int.any() or e.samples_frac.any():
        effects.append(e)
    if mod_samples > 0.0:
        effects.append(
            ModDelayEffect(name, istream, selector, mod_samples, mod_bw, mod_mono, mod_qual)
        )
    if not effects:
        e.unused = True
        return [e]
    return effects


register_effect(
    "delay",
    "delay [-f[order]] [-m|M depth[s|m|S|%]] [-b bw[k]] [-q quality] delay[s|m|S]",
    delay_effect_init,
)
