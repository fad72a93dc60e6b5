"""Biquad filter family: 20 effect names (reference: biquad.c,
biquad.h). RBJ cookbook designs, transposed direct-form 2, run on the
device by the K1 (blocked) or K2 (per-sample scan) kernels of
dsp_tpu_torch.ops.iir.

Width suffixes q/s/d/o/h/k and the bw<order>[.n] Butterworth-cascade macro
match parse_width (biquad.c:27-89). Coefficients are stored per channel with
identity on unselected channels so the kernel is branch-free; merging two
biquads on disjoint channel sets just copies coefficient columns
(biquad.c:361-376).
"""

import numpy as np
import torch

from dsp_tpu_torch.core.parse import ParseError, getopt, parse_freq, strtod, strtol
from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_CH_DEPS_IDENTITY,
    EFFECT_FLAG_OPT_REORDERABLE,
    Effect,
    EffectError,
    register_effect,
)
from dsp_tpu_torch.ops import iir

# effect numbers (biquad.h:30-52)
LOWPASS_1 = 1
HIGHPASS_1 = 2
ALLPASS_1 = 3
LOWSHELF_1 = 4
HIGHSHELF_1 = 5
LOWPASS_1P = 6
LOWPASS = 7
HIGHPASS = 8
BANDPASS_SKIRT = 9
BANDPASS_PEAK = 10
NOTCH = 11
ALLPASS = 12
PEAK = 13
LOWSHELF = 14
HIGHSHELF = 15
LOWPASS_TRANSFORM = 16
HIGHPASS_TRANSFORM = 17
DEEMPH = 18
BIQUAD = 19

def biquad_settle_frames(c, fs, eps=1e-9, cap_s=60.0):
    """Frames for the impulse response of biquads c [5, C] to decay to eps.

    Pole radius from z^2 + a1 z + a2 (c rows 3/4); n = ln(eps)/ln(r). Capped
    at cap_s seconds: a pole that close to the unit circle never truly
    settles, and the split-processing caller degrades gracefully (larger
    warmup error) rather than exploding the lookback.
    """
    n = 0.0
    for k in range(c.shape[1]):
        a1, a2 = float(c[3, k]), float(c[4, k])
        if a1 == 0.0 and a2 == 0.0:
            # FIR-only biquad (e.g. `biquad b0 b1 b2 1 0 0`): no poles, but
            # TDF2 state still carries 2 samples of input history through the
            # b1/b2 terms — a 0 lookback would drop them at split boundaries.
            if float(c[1, k]) != 0.0 or float(c[2, k]) != 0.0:
                n = max(n, 2.0)
            continue
        r = float(np.max(np.abs(np.roots([1.0, a1, a2]))))
        if r <= eps:
            continue
        if r >= 1.0 - 1e-12:
            n = cap_s * fs
            break
        n = max(n, np.log(eps) / np.log(r))
    return int(min(n, cap_s * fs))


WIDTH_Q = 1
WIDTH_SLOPE = 2
WIDTH_SLOPE_DB = 3
WIDTH_BW_OCT = 4
WIDTH_BW_HZ = 5


def parse_width(s):
    """Width with optional suffix or bw<order>[.n] macro -> (width, type).

    Mirrors biquad.c:27-89 including ascending-Q indexing of the Butterworth
    macro: Q = 1/(2 sin(pi/order * (p_idx - 0.5))) indexed from the outermost
    conjugate pair.
    """
    if s.startswith("bw") and len(s) > 2:
        order, rest = strtol(s[2:])
        if rest == s[2:] or (rest and not rest.startswith(".")):
            raise ParseError(f"failed to parse width: {s!r}")
        if order < 2:
            raise ParseError("filter order must be >= 2")
        n_biquads = order // 2
        p_idx = 0
        if rest.startswith("."):
            p_idx, rest2 = strtol(rest[1:])
            if rest2 == rest[1:] or rest2:
                raise ParseError(f"failed to parse width: {s!r}")
            if p_idx < 0 or p_idx >= n_biquads:
                raise ParseError("filter index out of range")
        p_idx = n_biquads - p_idx
        return 1.0 / (2.0 * np.sin(np.pi / order * (p_idx - 0.5))), WIDTH_Q
    w, rest = strtod(s)
    if rest == s:
        raise ParseError(f"failed to parse width: {s!r}")
    wtype = WIDTH_Q
    if rest:
        c = rest[0]
        if c == "q":
            wtype = WIDTH_Q
        elif c == "s":
            wtype = WIDTH_SLOPE
        elif c == "d":
            wtype = WIDTH_SLOPE_DB
        elif c == "o":
            wtype = WIDTH_BW_OCT
        elif c == "k":
            w *= 1000.0
            wtype = WIDTH_BW_HZ
        elif c == "h":
            wtype = WIDTH_BW_HZ
        else:
            raise ParseError(f"failed to parse width: {s!r}")
        if rest[1:]:
            raise ParseError(f"trailing characters: {rest[1:]}")
    return w, wtype


def design(type_, fs, arg0=0.0, arg1=0.0, arg2=0.0, arg3=0.0, width_type=WIDTH_Q):
    """Compute (b0,b1,b2,a0,a1,a2) for a filter type (biquad.c:111-294)."""
    b0, b1, b2, a0, a1, a2 = 1.0, 0.0, 0.0, 1.0, 0.0, 0.0
    if type_ in (LOWPASS_TRANSFORM, HIGHPASS_TRANSFORM):
        fz, qz, fp, qp = arg0, arg1, arg2, arg3
        w0z, w0p = 2 * np.pi * fz / fs, 2 * np.pi * fp / fs
        cz, cp = np.cos(w0z), np.cos(w0p)
        az, ap = np.sin(w0z) / (2 * qz), np.sin(w0p) / (2 * qp)
        if type_ == LOWPASS_TRANSFORM:
            kz, kp = 2.0 / (1.0 - cz), 2.0 / (1.0 - cp)
        else:
            kz, kp = 2.0 / (1.0 + cz), 2.0 / (1.0 + cp)
        b0 = (1.0 + az) * kz
        b1 = (-2.0 * cz) * kz
        b2 = (1.0 - az) * kz
        a0 = (1.0 + ap) * kp
        a1 = (-2.0 * cp) * kp
        a2 = (1.0 - ap) * kp
        return b0, b1, b2, a0, a1, a2

    f0, width, gain = arg0, arg1, arg2
    if width_type == WIDTH_SLOPE_DB:
        width_type = WIDTH_SLOPE
        width = width / 12.0
        if type_ == LOWSHELF:
            f0 *= 10.0 ** (abs(gain) / 80.0 / width)
        elif type_ == HIGHSHELF:
            f0 /= 10.0 ** (abs(gain) / 80.0 / width)
    a = 10.0 ** (gain / 40.0)
    w0 = 2 * np.pi * f0 / fs
    sin_w0, cos_w0 = np.sin(w0), np.cos(w0)
    if width_type == WIDTH_SLOPE:
        alpha = sin_w0 / 2.0 * np.sqrt((a + 1.0 / a) * (1.0 / width - 1.0) + 2.0)
    elif width_type == WIDTH_BW_OCT:
        alpha = sin_w0 * np.sinh(np.log(2.0) / 2.0 * width * w0 / sin_w0)
    elif width_type == WIDTH_BW_HZ:
        alpha = sin_w0 / (2.0 * f0 / width) if width else 0.0
    else:
        alpha = sin_w0 / (2.0 * width) if width else 0.0  # unused by 1st-order types

    if type_ == LOWPASS_1:
        c = 1.0 + cos_w0
        b0 = b1 = sin_w0
        b2 = 0.0
        a0 = sin_w0 + c
        a1 = sin_w0 - c
        a2 = 0.0
    elif type_ == HIGHPASS_1:
        c = 1.0 + cos_w0
        b0, b1, b2 = c, -c, 0.0
        a0 = sin_w0 + c
        a1 = sin_w0 - c
        a2 = 0.0
    elif type_ == ALLPASS_1:
        c = 1.0 + cos_w0
        b0 = sin_w0 - c
        b1 = sin_w0 + c
        b2 = 0.0
        a0, a1, a2 = b1, b0, 0.0
    elif type_ == LOWSHELF_1:
        c = 1.0 + cos_w0
        b0 = a * sin_w0 + c
        b1 = a * sin_w0 - c
        b2 = 0.0
        a0 = sin_w0 / a + c
        a1 = sin_w0 / a - c
        a2 = 0.0
    elif type_ == HIGHSHELF_1:
        c = 1.0 + cos_w0
        b0 = sin_w0 + c * a
        b1 = sin_w0 - c * a
        b2 = 0.0
        a0 = sin_w0 + c / a
        a1 = sin_w0 - c / a
        a2 = 0.0
    elif type_ == LOWPASS_1P:
        c = 1.0 - cos_w0
        b0 = -c + np.sqrt(c * c + 2.0 * c)
        b1 = b2 = 0.0
        a0 = 1.0
        a1 = -1.0 + b0
        a2 = 0.0
    elif type_ == LOWPASS:
        b0 = (1.0 - cos_w0) / 2.0
        b1 = 1.0 - cos_w0
        b2 = b0
        a0 = 1.0 + alpha
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha
    elif type_ == HIGHPASS:
        b0 = (1.0 + cos_w0) / 2.0
        b1 = -(1.0 + cos_w0)
        b2 = b0
        a0 = 1.0 + alpha
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha
    elif type_ == BANDPASS_SKIRT:
        b0 = sin_w0 / 2.0
        b1 = 0.0
        b2 = -b0
        a0 = 1.0 + alpha
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha
    elif type_ == BANDPASS_PEAK:
        b0 = alpha
        b1 = 0.0
        b2 = -alpha
        a0 = 1.0 + alpha
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha
    elif type_ == NOTCH:
        b0 = 1.0
        b1 = -2.0 * cos_w0
        b2 = 1.0
        a0 = 1.0 + alpha
        a1 = b1
        a2 = 1.0 - alpha
    elif type_ == ALLPASS:
        b0 = 1.0 - alpha
        b1 = -2.0 * cos_w0
        b2 = 1.0 + alpha
        a0, a1, a2 = b2, b1, b0
    elif type_ == PEAK:
        b0 = 1.0 + alpha * a
        b1 = -2.0 * cos_w0
        b2 = 1.0 - alpha * a
        a0 = 1.0 + alpha / a
        a1 = b1
        a2 = 1.0 - alpha / a
    elif type_ == LOWSHELF:
        c = 2.0 * np.sqrt(a) * alpha
        b0 = a * ((a + 1.0) - (a - 1.0) * cos_w0 + c)
        b1 = 2.0 * a * ((a - 1.0) - (a + 1.0) * cos_w0)
        b2 = a * ((a + 1.0) - (a - 1.0) * cos_w0 - c)
        a0 = (a + 1.0) + (a - 1.0) * cos_w0 + c
        a1 = -2.0 * ((a - 1.0) + (a + 1.0) * cos_w0)
        a2 = (a + 1.0) + (a - 1.0) * cos_w0 - c
    elif type_ == HIGHSHELF:
        c = 2.0 * np.sqrt(a) * alpha
        b0 = a * ((a + 1.0) + (a - 1.0) * cos_w0 + c)
        b1 = -2.0 * a * ((a - 1.0) + (a + 1.0) * cos_w0)
        b2 = a * ((a + 1.0) + (a - 1.0) * cos_w0 - c)
        a0 = (a + 1.0) - (a - 1.0) * cos_w0 + c
        a1 = 2.0 * ((a - 1.0) - (a + 1.0) * cos_w0)
        a2 = (a + 1.0) - (a - 1.0) * cos_w0 - c
    else:
        raise EffectError(f"biquad: unknown type {type_}")
    return b0, b1, b2, a0, a1, a2


def normalize(b0, b1, b2, a0, a1, a2):
    """(c0..c4) = (b0,b1,b2,a1,a2)/a0 (biquad.c:91-99)."""
    return b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0


class BiquadEffect(Effect):
    def __init__(self, name, istream, selector, coeffs):
        """coeffs: (c0..c4) applied on selected channels; identity elsewhere."""
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_OPT_REORDERABLE | EFFECT_FLAG_CH_DEPS_IDENTITY
        n = istream.channels
        self.c = iir.make_identity_biquad(n)
        for k in range(n):
            if self.channel_selector[k]:
                self.c[:, k] = coeffs
        self._set_scan_ss()

    def _set_scan_ss(self):
        # host-side coupled-form ss for the per-sample path, so states stay
        # interchangeable with the blocked path's basis (iir._coupled_form_ss)
        self._ss_A, self._ss_Bv = iir._coupled_form_ss(self.c)
        self._ss_c0 = self.c[0].copy()

    def split_lookback(self):
        return biquad_settle_frames(self.c, self.istream.fs)

    def state0(self):
        # [hi/lo, C, 2]: double-float pair of TDF2 memories so block
        # boundaries keep the blocked kernel's carry precision (ops/iir.py)
        return np.zeros((2, self.istream.channels, 2), dtype=np.float64)

    def _plan(self):
        plan = getattr(self, "_blocked_plan", None)
        if plan is None or not np.array_equal(plan._src, self.c):
            plan = iir.BiquadBlockedPlan(self.c)
            plan._src = self.c.copy()
            self._blocked_plan = plan
        return plan

    def step(self, state, x):
        B = x.shape[-2]
        if B % iir.BLOCKED_L == 0 and B >= 2 * iir.BLOCKED_L:
            # blocked path (K1, K1-df under float32) from the host-precomputed
            # f64 tables
            return iir.lti_blocked(self._plan(), state, x)
        names = ("_ss_A", "_ss_Bv", "_ss_c0")
        if x.dtype == torch.float32:
            # per-sample path under float32 (K3): the float64 coupled form
            # and the (hi, lo) state, as dsp_tpu's biquad_scan_df
            A, Bv, c0 = (self.device_array(k, x, torch.float64) for k in names)
            return iir.biquad_scan_df(A, Bv, c0, state, x)
        # per-sample path (K2, the (hi, lo) state read and written in the
        # kernel)
        A, Bv, c0 = (self.device_array(k, x) for k in names)
        return iir.biquad_scan_pair(A, Bv, c0, state, x)

    def merge(self, other):
        if type(other) is not type(self):
            return False
        if (other.channel_selector & self.channel_selector).any():
            return False
        sel = other.channel_selector
        self.c[:, sel] = other.c[:, sel]
        self.channel_selector |= sel
        self._set_scan_ss()
        return True

    def plot(self, idx, channel_offset=0):
        lines = []
        for k in range(self.ostream.channels):
            if self.channel_selector[k]:
                c0, c1, c2, c3, c4 = self.c[:, k]
                lines.append(
                    f"H{k}_{idx}(w)=(abs(w)<=pi)?("
                    f"{c0:.15e}+{c1:.15e}*exp(-j*w)+{c2:.15e}*exp(-2.0*j*w))/"
                    f"(1.0+{c3:.15e}*exp(-j*w)+{c4:.15e}*exp(-2.0*j*w)):0/0"
                )
            else:
                lines.append(f"H{k}_{idx}(w)=1.0")
        return lines


def _get_freq(s, name, fs, effect_name):
    try:
        v = parse_freq(s)
    except ParseError:
        raise EffectError(f"{effect_name}: failed to parse {name}: {s}")
    if not (0.0 <= v < fs / 2.0):
        raise EffectError(f"{effect_name}: {name} out of range")
    return v


def _get_float(s, name, effect_name):
    v, rest = strtod(s)
    if rest == s or rest:
        raise EffectError(f"{effect_name}: failed to parse {name}: {s}")
    return v


def _get_width(s, name, effect_name):
    try:
        w, wt = parse_width(s)
    except ParseError as e:
        raise EffectError(f"{effect_name}: failed to parse {name}: {e}")
    if w <= 0.0:
        raise EffectError(f"{effect_name}: {name} out of range")
    return w, wt


_NO_SLOPE = (WIDTH_Q, WIDTH_BW_OCT, WIDTH_BW_HZ)


_N_POSITIONAL = {
    LOWPASS_1: 1, HIGHPASS_1: 1, ALLPASS_1: 1, LOWPASS_1P: 1,
    LOWSHELF_1: 2, HIGHSHELF_1: 2,
    LOWPASS: 2, HIGHPASS: 2, BANDPASS_SKIRT: 2, BANDPASS_PEAK: 2,
    NOTCH: 2, ALLPASS: 2,
    PEAK: 3, LOWSHELF: 3, HIGHSHELF: 3,
    LOWPASS_TRANSFORM: 4, HIGHPASS_TRANSFORM: 4,
    DEEMPH: 0, BIQUAD: 6,
}


def biquad_effect_init(ei, istream, selector, dir_, argv):
    name = argv[0]
    args = argv[1:]
    # -r[thresh] option (time-reversed IIR). Like the reference's
    # INIT_COMMON (biquad.c:432-434), option scanning EXCLUDES the trailing
    # positional arguments, so a negative positional (e.g. `biquad -0.5 ...`)
    # is never mistaken for an option.
    n_pos = _N_POSITIONAL[ei.effect_number]
    if len(args) < n_pos:
        raise EffectError(f"{name}: usage: {ei.usage}")
    opt_args = args[: len(args) - n_pos] if n_pos else args
    try:
        opts, ind = getopt(opt_args, "r::")
    except ParseError as e:
        raise EffectError(f"{name}: {e}")
    if ind != len(opt_args):
        raise EffectError(f"{name}: usage: {ei.usage}")
    args = args[len(args) - n_pos :] if n_pos else args[ind:]
    reverse = False
    thresh = 80.0
    for opt, arg in opts:
        if opt == "r":
            reverse = True
            if arg is not None:
                t, rest = strtol(arg)
                if rest == arg or rest:
                    raise EffectError(f"{name}: failed to parse thresh: {arg}")
                if not (10.0 <= t <= 200.0):
                    raise EffectError(f"{name}: thresh out of range")
                thresh = float(t)

    en = ei.effect_number
    wt = WIDTH_Q

    def narg(n):
        if len(args) != n:
            raise EffectError(f"{name}: usage: {ei.usage}")

    if en in (LOWPASS_1, HIGHPASS_1, ALLPASS_1, LOWPASS_1P):
        narg(1)
        f0 = _get_freq(args[0], "f0", istream.fs, name)
        coeffs = design(en, istream.fs, f0)
    elif en in (LOWSHELF_1, HIGHSHELF_1):
        narg(2)
        f0 = _get_freq(args[0], "f0", istream.fs, name)
        gain = _get_float(args[1], "gain", name)
        coeffs = design(en, istream.fs, f0, 0.0, gain)
    elif en in (LOWPASS, HIGHPASS, BANDPASS_SKIRT, BANDPASS_PEAK, NOTCH, ALLPASS):
        narg(2)
        f0 = _get_freq(args[0], "f0", istream.fs, name)
        width, wt = _get_width(args[1], "width", name)
        if wt not in _NO_SLOPE:
            raise EffectError(f"{name}: invalid width type")
        coeffs = design(en, istream.fs, f0, width, 0.0, 0.0, wt)
    elif en in (PEAK, LOWSHELF, HIGHSHELF):
        narg(3)
        f0 = _get_freq(args[0], "f0", istream.fs, name)
        width, wt = _get_width(args[1], "width", name)
        if en == PEAK and wt not in _NO_SLOPE:
            raise EffectError(f"{name}: invalid width type")
        gain = _get_float(args[2], "gain", name)
        coeffs = design(en, istream.fs, f0, width, gain, 0.0, wt)
    elif en in (LOWPASS_TRANSFORM, HIGHPASS_TRANSFORM):
        narg(4)
        fz = _get_freq(args[0], "fz", istream.fs, name)
        wz, wt = _get_width(args[1], "width_z", name)
        if wt != WIDTH_Q:
            raise EffectError(f"{name}: invalid width type")
        fp = _get_freq(args[2], "fp", istream.fs, name)
        wp, wt = _get_width(args[3], "width_p", name)
        if wt != WIDTH_Q:
            raise EffectError(f"{name}: invalid width type")
        coeffs = design(en, istream.fs, fz, wz, fp, wp)
    elif en == DEEMPH:
        narg(0)
        if istream.fs == 44100:
            f0, width, gain = 5283.0, 0.4845, -9.477
        elif istream.fs == 48000:
            f0, width, gain = 5356.0, 0.479, -9.62
        else:
            raise EffectError(f"{name}: sample rate must be 44100 or 48000")
        coeffs = design(HIGHSHELF, istream.fs, f0, width, gain, 0.0, WIDTH_SLOPE)
    elif en == BIQUAD:
        narg(6)
        vals = [_get_float(a, n, name) for a, n in zip(args, ("b0", "b1", "b2", "a0", "a1", "a2"))]
        coeffs = tuple(vals)
    else:
        raise EffectError(f"{name}: bad effect number")

    c = normalize(*coeffs)

    if reverse:
        from dsp_tpu_torch.effects.reverse_iir import reverse_iir_from_biquad

        return reverse_iir_from_biquad(name, istream, selector, c, thresh)

    return BiquadEffect(name, istream, selector, c)


_USAGES = [
    ("lowpass_1", "[-r[thresh]] f0[k]", LOWPASS_1),
    ("highpass_1", "[-r[thresh]] f0[k]", HIGHPASS_1),
    ("allpass_1", "[-r[thresh]] f0[k]", ALLPASS_1),
    ("lowshelf_1", "[-r[thresh]] f0[k] gain", LOWSHELF_1),
    ("highshelf_1", "[-r[thresh]] f0[k] gain", HIGHSHELF_1),
    ("lowpass_1p", "[-r[thresh]] f0[k]", LOWPASS_1P),
    ("lowpass", "[-r[thresh]] f0[k] width[q|o|h|k]", LOWPASS),
    ("highpass", "[-r[thresh]] f0[k] width[q|o|h|k]", HIGHPASS),
    ("bandpass_skirt", "[-r[thresh]] f0[k] width[q|o|h|k]", BANDPASS_SKIRT),
    ("bandpass_peak", "[-r[thresh]] f0[k] width[q|o|h|k]", BANDPASS_PEAK),
    ("notch", "[-r[thresh]] f0[k] width[q|o|h|k]", NOTCH),
    ("allpass", "[-r[thresh]] f0[k] width[q|o|h|k]", ALLPASS),
    ("eq", "[-r[thresh]] f0[k] width[q|o|h|k] gain", PEAK),
    ("lowshelf", "[-r[thresh]] f0[k] width[q|s|d|o|h|k] gain", LOWSHELF),
    ("highshelf", "[-r[thresh]] f0[k] width[q|s|d|o|h|k] gain", HIGHSHELF),
    ("lowpass_transform", "[-r[thresh]] fz[k] width_z[q] fp[k] width_p[q]", LOWPASS_TRANSFORM),
    ("highpass_transform", "[-r[thresh]] fz[k] width_z[q] fp[k] width_p[q]", HIGHPASS_TRANSFORM),
    ("linkwitz_transform", "[-r[thresh]] fz[k] width_z[q] fp[k] width_p[q]", HIGHPASS_TRANSFORM),
    ("deemph", "[-r[thresh]]", DEEMPH),
    ("biquad", "[-r[thresh]] b0 b1 b2 a0 a1 a2", BIQUAD),
]

for _name, _usage, _num in _USAGES:
    register_effect(_name, f"{_name} {_usage}", biquad_effect_init, _num)


class BiquadRun:
    """Execution-time grouping of 2 to iir's stage limit adjacent
    BiquadEffects at a block that runs them per sample (one that
    chain.CompiledChain._fuse leaves unfused): the run steps in one launch
    (iir.biquad_scan_run, K2 or K3 a stage) instead of one a biquad, each
    biquad's [2, C, 2] state read and written where it is. The chain's
    runtime effects, their names and their states stay the biquads' own;
    the coefficient table is built once, on `device`."""

    def __init__(self, effects, device):
        self.effects = effects
        self._coef = tuple(
            torch.as_tensor(np.stack([getattr(e, k) for e in effects]), dtype=torch.float64,
                            device=device)
            for k in ("_ss_A", "_ss_Bv", "_ss_c0"))

    def step(self, states, x):
        """The biquads' states in order and x -> (their end states, y)."""
        return iir.biquad_scan_run(*self._coef, states, x)


class FusedBiquadCascade:
    """Compile-time fusion of consecutive BiquadEffects (execution only).

    Built by chain.CompiledChain when 2+ biquads run back-to-back on the same
    stream with a blocked-kernel-compatible block size; runs on K1; the user-visible
    chain (plot output, effect listing, merge semantics) stays identical to
    the reference, which keeps same-channel biquads separate
    (biquad.c:344-376 only merges disjoint selectors).
    """

    name = "biquad(fused-cascade)"
    ratio = 1
    runtime_noop = False

    def __init__(self, effects):
        self.effects = effects
        self.istream = effects[0].istream
        self.ostream = effects[-1].ostream
        self._plan = iir.CascadeBlockedPlan([e.c for e in effects])

    def split_lookback(self):
        # cascade transients convolve: the sum of per-section settle times
        # bounds the cascade's settle time. NOTE: chain-level lookback
        # (CompiledChain.split_lookback_frames) is computed over the unfused
        # chain.effects list BEFORE fusion, which yields the same sum; this
        # method exists for direct callers of the runtime object.
        return sum(e.split_lookback() for e in self.effects)

    def state0(self):
        return np.zeros((2, self.istream.channels, self._plan.n), dtype=np.float64)

    def step(self, state, x):
        return iir.lti_blocked(self._plan, state, x)

    # runtime-only wrapper: the constituent effects stay in the chain object,
    # so host-side hooks are no-ops here (biquads define none anyway)
    def host_update(self, state):
        pass

    def host_finish(self, state):
        pass

    def signal(self):
        pass
