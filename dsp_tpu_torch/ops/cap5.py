"""CAP5: 5th-order complementary allpass pair crossovers
(reference: cap5.c), ported from dsp_tpu.ops.cap5 unchanged:
host numpy only.

A cap5 split is two parallel allpasses A1 (2nd order) and A2 (3rd order =
2nd + 1st); lp = (A1+A2)/2, hp = (A1-A2)/2. Analog prototype poles come from
Butterworth, Chebyshev (type 1/2 via asinh), or elliptic (nome-series +
regula-falsi wc search) designs, then bilinear transform at the pre-warped
crossover (cap5.c:196-219).

This module computes the digital section coefficients (host-side numpy) and
provides a sequential numpy executor of a filter-bank program used at init
time (impulse responses for the matrix4_mb phase-linearization FIR).
"""

import numpy as np


def butterworth_ap():
    ap = np.zeros(3, dtype=complex)
    for i in range(3):
        theta = (2 * i + 1) * np.pi / 10.0
        ap[i] = -np.sin(theta) + 1j * np.cos(theta)
    return ap


def chebyshev_ap(gen_type2, stop_db):
    if stop_db > 100.0:
        return butterworth_ap()
    epsilon = np.sqrt(10.0 ** (stop_db / 10.0) - 1.0)
    sigma = np.arcsinh(epsilon) / 5.0
    scale = np.cosh(np.arccosh(epsilon) / 5.0)
    ap = np.zeros(3, dtype=complex)
    for i in range(3):
        theta = (2 * i + 1) * np.pi / 10.0
        p = -np.sinh(sigma) * np.sin(theta) + 1j * np.cosh(sigma) * np.cos(theta)
        p = p / scale
        if gen_type2:
            p = 1.0 / p
        ap[i] = p
    return ap


def _find_zero(fn, a, b, tol=0.0):
    """Illinois regula falsi (cap5.c:69-93)."""
    if tol < np.finfo(float).eps:
        tol = np.finfo(float).eps * 2
    fn_a, fn_b = fn(a), fn(b)
    c = a
    side = 0
    for i in range(100):
        c = (fn_a * b - fn_b * a) / (fn_a - fn_b)
        if abs(b - a) < tol * abs(b + a):
            return c
        fn_c = fn(c)
        if np.sign(fn_b) == np.sign(fn_c):
            b, fn_b = c, fn_c
            if side == -1:
                fn_a /= 2.0
            side = -1
        elif np.sign(fn_a) == np.sign(fn_c):
            a, fn_a = c, fn_c
            if side == 1:
                fn_b /= 2.0
            side = 1
        else:
            if i == 0:
                return np.nan
            return c
    return np.nan


def _eval_allpass_ap(ap, jw):
    has_real = ap[-1].imag == 0
    num = jw + ap[-1] if has_real else 1.0
    den = jw - ap[-1] if has_real else 1.0
    n = len(ap) - 1 if has_real else len(ap)
    for i in range(n):
        num *= (jw + ap[i]) * (jw + np.conj(ap[i]))
        den *= (jw - ap[i]) * (jw - np.conj(ap[i]))
    return num / den


def elliptic_ap(stop_db_lp, stop_db_hp):
    if stop_db_lp > 100.0:
        return chebyshev_ap(0, stop_db_hp)
    if stop_db_hp > 100.0:
        return chebyshev_ap(1, stop_db_lp)
    e2 = 1.0 / (10.0 ** (stop_db_hp / 10.0) - 1.0)
    D = (10.0 ** (stop_db_lp / 10.0) - 1.0) / e2
    q_target = 1.0 / (2.0 ** (4.0 / 5.0) * D ** (1.0 / 5.0))

    def q_err(k):
        kp = np.sqrt(np.sqrt(1.0 - k * k))
        l = (1.0 - kp) / ((1.0 + kp) * 2.0)
        return (l + 2.0 * l**5 + 15.0 * l**9 + 150.0 * l**13) - q_target

    k = _find_zero(q_err, 0.0, 1.0)
    if not np.isfinite(k) or k <= 0:
        return butterworth_ap()
    q = q_target
    L = np.log((np.sqrt(1.0 + e2) + 1.0) / (np.sqrt(1.0 + e2) - 1.0)) / 10.0
    s0 = np.sinh(L)
    s1 = 0.0
    for m in range(1, 6):
        sgn = -1 if m & 1 else 1
        s0 += sgn * q ** (m * (m + 1)) * np.sinh((2 * m + 1) * L)
        s1 += sgn * q ** (m * m) * np.cosh(2 * m * L)
    sigma0 = abs((2.0 * q**0.25 * s0) / (1.0 + 2.0 * s1))
    sigma02 = sigma0 * sigma0
    W = np.sqrt((1.0 + k * sigma02) * (1.0 + sigma02 / k))
    ap = np.zeros(3, dtype=complex)
    for i in range(2):
        mu = 2.0 - i
        o0 = np.sin(np.pi * mu / 5.0)
        o1 = 0.0
        for m in range(1, 6):
            sgn = -1 if m & 1 else 1
            o0 += sgn * q ** (m * (m + 1)) * np.sin((2 * m + 1) * np.pi * mu / 5.0)
            o1 += sgn * q ** (m * m) * np.cos(2 * m * np.pi * mu / 5.0)
        omega = (2.0 * q**0.25 * o0) / (1.0 + 2.0 * o1)
        omega2 = omega * omega
        Vi = np.sqrt((1.0 - k * omega2) * (1.0 - omega2 / k))
        ap[i] = (-2.0 * sigma0 * Vi + 2j * omega * W) / (2.0 * (1.0 + sigma02 * omega2))
    ap[2] = -sigma0
    if abs(stop_db_lp - stop_db_hp) > 0.01:
        ap0 = np.array([ap[1]])
        ap1 = np.array([ap[0], ap[2]])

        def wc_err(w):
            a = _eval_allpass_ap(ap0, 1j * w)
            b = _eval_allpass_ap(ap1, 1j * w)
            return a.real * b.real + a.imag * b.imag

        half_width = np.sqrt(1.0 / k)
        wc = _find_zero(wc_err, 1.0 / half_width, half_width)
        if not np.isfinite(wc):
            return butterworth_ap()
        ap = ap / wc
    return ap


def cap5_coeffs(fs, fc, ap):
    """Digital section coefficients (cap5.c:196-219).

    Returns dict: a1 = (c0, c1) 2nd-order allpass; a2_ap2 = (c0, c1);
    a2_ap1 = c0 (1st-order allpass).
    """
    fc_w = 2.0 * fs * np.tan(np.pi * fc / fs)
    p = ap * fc_w
    p = (2.0 * fs + p) / (2.0 * fs - p)
    return {
        "a2_ap2": (-2.0 * p[0].real, p[0].real ** 2 + p[0].imag ** 2),
        "a1": (-2.0 * p[1].real, p[1].real ** 2 + p[1].imag ** 2),
        "a2_ap1": -p[2].real,
    }


def ap2_biquad(c0, c1):
    """2nd-order allpass as normalized biquad (num mirrored den)."""
    return np.array([c1, c0, 1.0, c0, c1])


def ap1_biquad(c0):
    """1st-order allpass as a biquad row."""
    return np.array([c0, 1.0, 0.0, c0, 0.0])


# 13-band bank tables (matrix4_mb.c:52-55)
FB_FDIV_13 = [170, 316.39, 516.52, 790.1, 1164.1, 1675.4, 2374.3, 3329.8, 4636.1, 6421.7, 8862.9, 12200]
FB_FC_13 = [112.28, 237.49, 408.65, 642.64, 962.52, 1399.8, 1997.6, 2814.8, 3932, 5459.3, 7547.1, 10401, 14303]
FB_AP_IDX_13 = [6, 7, 8, 9, 10, 11, 4, 3, 2, 1, 0, 3, 4, 1, 0, 1, 4, 9, 10, 11, 7, 6, 7, 11, 9]

# execution program for the 13-band tree (filter_bank_run, N_BANDS == 13):
# ("cap5", f_idx, in, lp_out, hp_out) or ("ap", ap_idx, sig)
FB_PROGRAM_13 = [
    ("cap5", 5, "in", "s5", "s6"),
    ("ap", 0, "s5"), ("ap", 1, "s5"), ("ap", 2, "s5"), ("ap", 3, "s5"), ("ap", 4, "s5"), ("ap", 5, "s5"),
    ("ap", 6, "s6"), ("ap", 7, "s6"), ("ap", 8, "s6"), ("ap", 9, "s6"), ("ap", 10, "s6"),
    ("cap5", 2, "s5", "s2", "s3"),
    ("ap", 11, "s2"), ("ap", 12, "s2"),
    ("ap", 13, "s3"), ("ap", 14, "s3"),
    ("cap5", 0, "s2", "s0", "s1"),
    ("ap", 15, "s0"),
    ("cap5", 1, "s1", "s1", "s2"),
    ("cap5", 3, "s3", "s3", "s4"),
    ("ap", 16, "s3"),
    ("cap5", 4, "s4", "s4", "s5"),
    ("cap5", 8, "s6", "s8", "s9"),
    ("ap", 17, "s8"), ("ap", 18, "s8"), ("ap", 19, "s8"),
    ("ap", 20, "s9"), ("ap", 21, "s9"),
    ("cap5", 6, "s8", "s6", "s7"),
    ("ap", 22, "s6"),
    ("cap5", 7, "s7", "s7", "s8"),
    ("cap5", 10, "s9", "s10", "s11"),
    ("ap", 23, "s10"),
    ("ap", 24, "s11"),
    ("cap5", 9, "s10", "s9", "s10"),
    ("cap5", 11, "s11", "s11", "s12"),
]
N_BANDS = 13


def build_filter_bank(fs, fb_type, fb_stop):
    """-> (cap5 coeff list indexed by f_idx, comp-ap coeff list by ap order)."""
    if fb_type == "butterworth":
        ap = butterworth_ap()
    elif fb_type == "chebyshev1":
        ap = chebyshev_ap(0, fb_stop[0])
    elif fb_type == "chebyshev2":
        ap = chebyshev_ap(1, fb_stop[0])
    else:
        ap = elliptic_ap(fb_stop[0], fb_stop[1])
    caps = [cap5_coeffs(fs, fc, ap) for fc in FB_FDIV_13]
    comp = [caps[i]["a1"] for i in FB_AP_IDX_13]
    return caps, comp


class NumpyBank:
    """Sequential numpy executor (init-time impulse responses only)."""

    def __init__(self, caps, comp):
        self.caps = caps
        self.comp = comp
        self.reset()

    def reset(self):
        self.st_a1 = [[0.0, 0.0, 0.0, 0.0] for _ in self.caps]  # i0 o0 i1 o1
        self.st_a2p = [[0.0, 0.0, 0.0, 0.0] for _ in self.caps]
        self.st_a2o = [[0.0, 0.0] for _ in self.caps]  # ap1: i0 o0
        self.st_comp = [[0.0, 0.0, 0.0, 0.0] for _ in self.comp]

    @staticmethod
    def _ap2(st, c0, c1, s):
        r = st[2] + c0 * (st[0] - st[1]) + c1 * (s - st[3])
        st[2] = st[0]
        st[0] = s
        st[3] = st[1]
        st[1] = r
        return r

    @staticmethod
    def _ap1(st, c0, s):
        r = st[0] + c0 * (s - st[1])
        st[0] = s
        st[1] = r
        return r

    def run_sample(self, s):
        sig = {"in": s}
        bands = {}
        for op in FB_PROGRAM_13:
            if op[0] == "cap5":
                _, fi, i_n, lp_n, hp_n = op
                c = self.caps[fi]
                a1 = self._ap2(self.st_a1[fi], c["a1"][0], c["a1"][1], sig[i_n])
                a2 = self._ap2(self.st_a2p[fi], c["a2_ap2"][0], c["a2_ap2"][1], sig[i_n])
                a2 = self._ap1(self.st_a2o[fi], c["a2_ap1"], a2)
                sig[lp_n] = (a1 + a2) * 0.5
                sig[hp_n] = (a1 - a2) * 0.5
            else:
                _, ai, s_n = op
                c0, c1 = self.comp[ai]
                sig[s_n] = self._ap2(self.st_comp[ai], c0, c1, sig[s_n])
        for k in range(N_BANDS):
            bands[k] = sig[f"s{k}"]
        return np.array([bands[k] for k in range(N_BANDS)])
