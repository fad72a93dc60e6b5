"""stats effect: per-channel statistics (reference: stats.c).

DC offset, min, max, peak dBFS, RMS dBFS, crest factor, peak count, peak
sample, samples, length — printed when processing finishes. Accumulators are
device-side and carried in the effect state; the host reads them at the end
(host_finish).

Exactness notes (dsp_tpu's, kept here):

* min/max start at 0.0 (the reference's calloc'd state), and a sample only
  qualifies as a peak event when it is a new min or max (stats.c:57-69);
  peak equality uses exact float comparison, like the C.
* ``-i`` true-peak runs the reference's *gated* estimator exactly
  (stats.c:76-164): a 9-sample lookahead delay line feeds a 4x polyphase
  interpolator + quadratic peak fit, but only for STATS_INTERP_DELAY=18
  samples after a sample crosses the tmin/tmax thresholds. The filter ring
  with its moving pointer is re-expressed as a shift buffer: one insert is
  ``M' = shift4(M) + x*H`` with H derived by transliterating the C insert
  once on a unit impulse (_derive_insert_layout).
* Static block shapes mean the runner zero-pads the final block; the
  ``limit`` state (set via CompiledChain.set_valid_frames) stops every
  accumulator at the true stream end, so padding never enters the results.

Both modes run on the K16 kernel (ops/time_domain.stats_step): plain mode
as one launch of tiles of 256 samples over the card, -i as a block a
selected channel walking the block in windows of 32 (csrc/stats.cu);
``samples`` and ``limit`` stay on the device, so a step reads nothing back.
"""

import numpy as np

from dsp_tpu_torch.core import log
from dsp_tpu_torch.core.parse import ParseError, getopt, strtod, strtol
from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_ALIGN_BARRIER,
    EFFECT_FLAG_CH_DEPS_IDENTITY,
    EFFECT_FLAG_NO_DITHER,
    ChannelPick,
    Effect,
    EffectError,
    register_effect,
)
from dsp_tpu_torch.ops import time_domain
from dsp_tpu_torch.ops.time_domain import STATS_INTERP_DELAY

_NO_LIMIT = np.int64(time_domain.NO_LIMIT)

# the reference's 4x half filter with every 4th coefficient omitted
# (stats.c:78-87)
_R_COEFS = np.array([
    -9.353493881474939e-04, -2.811275711123766e-03, -3.165361696477658e-03,
    +5.929994218827107e-03, +1.065865725083938e-02, +9.308373173634579e-03,
    -1.340062089976642e-02, -2.227979776029874e-02, -1.833945608477310e-02,
    +2.430932418366197e-02, +3.925899279385184e-02, +3.157919724264597e-02,
    -4.056172445833198e-02, -6.489751870004079e-02, -5.192701793078084e-02,
    +6.684049697012354e-02, +1.078342211598459e-01, +8.751763525896815e-02,
    -1.187292496637064e-01, -2.001458972657618e-01, -1.729186314209981e-01,
    +2.957854651930789e-01, +6.325370350028462e-01, +8.988707620097378e-01,
])


def _derive_insert_layout():
    """Transliterate stats_interp_insert (stats.c:76-111) on a unit impulse
    to derive the shift-buffer contribution template H[64]: after the 4-slot
    shift, slot j of the new buffer receives x*H[j] per inserted sample x.
    (The y read taps are M[0..3] + x*(r0, r1, r2, 0).)"""
    m = np.zeros(64)
    r = _R_COEFS.copy()  # r[i] for x = 1
    x = 1.0
    p0 = 0
    # y[2..5] read m[p0..p0+3] (+ r0..r2); then the read slots are cleared
    p = (p0 + 4) & 0x3F
    m[p0:p0 + 4] = 0.0
    base = p  # state->p after the insert = new read position

    def grp(*vals):
        nonlocal p
        for v in vals:
            m[p & 0x3F] += v
            p = (p + 1) & 0x3F
        p = (p + 1) & 0x3F  # skipped slot (the omitted 4th phase)

    grp(r[3], r[4], r[5])
    grp(r[6], r[7], r[8])
    grp(r[9], r[10], r[11])
    grp(r[12], r[13], r[14])
    grp(r[15], r[16], r[17])
    grp(r[18], r[19], r[20])
    for v in (r[21], r[22], r[23], x):  # x fills the 4th slot (stats.c:104)
        m[p & 0x3F] += v
        p = (p + 1) & 0x3F
    grp(r[23], r[22], r[21])
    grp(r[20], r[19], r[18])
    grp(r[17], r[16], r[15])
    grp(r[14], r[13], r[12])
    grp(r[11], r[10], r[9])
    grp(r[8], r[7], r[6])
    grp(r[5], r[4], r[3])
    for v in (r[2], r[1], r[0]):  # tail group has no skip (stats.c:111)
        m[p & 0x3F] += v
        p = (p + 1) & 0x3F
    return np.roll(m, -base)


_INSERT_H = _derive_insert_layout()


class StatsEffect(Effect):
    split_safe = False  # host-visible whole-stream accumulators

    def __init__(self, name, istream, selector, ref_level, width, interp):
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_NO_DITHER | EFFECT_FLAG_ALIGN_BARRIER | EFFECT_FLAG_CH_DEPS_IDENTITY
        self.sel_idx = np.flatnonzero(self.channel_selector)
        self._pick = ChannelPick(self.sel_idx, istream.channels)
        self.ref = ref_level
        self.width = width
        self.interp = interp
        # the -i kernel's table: the insert template, then the direct taps r0..r2
        self._insert_table = np.concatenate([_INSERT_H, _R_COEFS[:3]])
        self._final = None

    def state0(self):
        n = len(self.sel_idx)
        st = {
            "sum": np.zeros(n),
            "sum_sq": np.zeros(n),
            # the reference calloc's its state: min/max/peak start at 0.0
            "min": np.zeros(n),
            "max": np.zeros(n),
            "peak": np.zeros(n),
            "peak_count": np.zeros(n, dtype=np.int64),
            "peak_frame": np.zeros(n, dtype=np.int64),
            "samples": np.zeros((), dtype=np.int64),
            "limit": _NO_LIMIT,
        }
        if self.interp:
            st.update(
                m=np.zeros((64, n)),
                y=np.zeros((6, n)),
                z=np.zeros((9, n)),
                nctr=np.zeros(n, dtype=np.int32),
                tmin=np.zeros(n),
                tmax=np.zeros(n),
            )
        return st

    def set_valid_limit(self, state, limit):
        """Host hook: absolute local-frame count of real (non-padding) data."""
        state = dict(state)
        state["limit"] = np.int64(limit)
        return state

    def plot(self, idx, channel_offset=0):
        # effect_plot_noop in the reference (stats.c:302)
        return [f"H{k}_{idx}(f)=1.0" for k in range(self.ostream.channels)]

    def step(self, state, x):
        xs = self._pick.take(x)
        table = self.device_array("_insert_table", xs) if self.interp else None
        return time_domain.stats_step(state, xs, table), x

    def _host_flush_interp(self, s):
        """The reference's end-of-stream interpolator drain
        (stats_effect_destroy, stats.c:219-236): STATS_INTERP_DELAY
        zero-fed iterations evaluate the samples still inside the lookahead
        ring and filter pipeline — without it, true peaks in the final ~18
        samples are missed. Pure numpy on the final (host) state."""
        H = _INSERT_H[:, None]
        c0, c1, c2 = (float(_R_COEFS[0]), float(_R_COEFS[1]), float(_R_COEFS[2]))
        M, y, z = s["m"].copy(), s["y"].copy(), s["z"].copy()
        nc = s["nctr"].copy()
        tmin, tmax = s["tmin"].copy(), s["tmax"].copy()
        mn, mx, pk = s["min"].copy(), s["max"].copy(), s["peak"].copy()
        cnt, frm = s["peak_count"].copy(), s["peak_frame"].copy()
        # the true end-of-stream index: "samples" (the reference uses
        # state->samples, stats.c:219) — "limit" is the 1<<62 sentinel when
        # set_valid_frames was never called (interactive runs)
        t0 = int(s["samples"])
        nch = z.shape[1]
        n4 = np.zeros((4, nch))
        for i in range(STATS_INTERP_DELAY):
            t = t0 + i
            do = nc > 0
            x = z[0]
            y_ins = np.stack(
                [y[4], y[5], M[0] + c0 * x, M[1] + c1 * x, M[2] + c2 * x, M[3]]
            )
            yn = np.where(do, y_ins, y)
            M_ins = np.concatenate([M[4:], n4], axis=0) + x[None, :] * H
            Mn = np.where(do, M_ins, M)
            r = np.zeros(nch, dtype=np.int64)
            for j in range(1, 5):
                d0 = yn[j] - yn[j - 1]
                d1 = yn[j] - yn[j + 1]
                skip = (
                    ((d0 > 0) & (d1 < 0))
                    | ((d0 < 0) & (d1 > 0))
                    | ((d0 == 0) & (d1 == 0))
                )
                use = do & ~skip
                dy = yn[j - 1] - yn[j + 1]
                den = yn[j - 1] - 2.0 * yn[j] + yn[j + 1]
                p4 = dy / (8.0 * np.where(den == 0, 1.0, den))
                yq = yn[j] - dy * p4
                is_min = use & (yq <= mn)
                is_max = use & ~is_min & (yq >= mx)
                mn = np.where(is_min, yq, mn)
                tmin = np.where(is_min, 0.5 * yq, tmin)
                mx = np.where(is_max, yq, mx)
                tmax = np.where(is_max, 0.5 * yq, tmax)
                ev = is_min | is_max
                ayq = np.abs(yq)
                gt = ev & (ayq > pk)
                eq = ev & (ayq > 0) & (ayq == pk)
                pk = np.where(gt, ayq, pk)
                r = np.where(gt, 2, np.where(eq, 1, r))
            frm = np.where(r == 2, t - (STATS_INTERP_DELAY - 1), frm)
            cnt = np.where(r == 2, 1, np.where(r == 1, cnt + 1, cnt))
            nc = np.where(do, nc - 1, nc)
            z = np.concatenate([z[1:], np.zeros((1, nch))], axis=0)
            M, y = Mn, yn
        s["min"], s["max"], s["peak"] = mn, mx, pk
        s["peak_count"], s["peak_frame"] = cnt, frm

    def host_finish(self, state):
        s = {k: v.cpu().numpy() for k, v in state.items()}
        if self.interp:
            self._host_flush_interp(s)
        self._final = s
        n = len(self.sel_idx)
        samples = int(s["samples"])
        if samples <= 0:
            return
        width = self.width
        if width < 0:
            from dsp_tpu_torch.cli import terminal

            width = terminal.term_width()
        cols = n if width == 0 else max((width - 18) // 13, 1)

        def db(v):
            with np.errstate(divide="ignore"):
                return 20.0 * np.log10(v)

        rows = [("Channel", [f"{int(self.sel_idx[i]):12d}" for i in range(n)])]
        rows.append(("DC offset", [f"{s['sum'][i] / samples:12.8f}" for i in range(n)]))
        rows.append(("Minimum", [f"{s['min'][i]:12.8f}" for i in range(n)]))
        rows.append(("Maximum", [f"{s['max'][i]:12.8f}" for i in range(n)]))
        rows.append(("Peak level (dBFS)", [f"{db(s['peak'][i]):12.4f}" for i in range(n)]))
        if self.ref is not None:
            rows.append(
                ("Peak level (dBr)", [f"{self.ref + db(s['peak'][i]):12.4f}" for i in range(n)])
            )
        rms = np.sqrt(s["sum_sq"] / samples)
        rows.append(("RMS level (dBFS)", [f"{db(rms[i]):12.4f}" for i in range(n)]))
        if self.ref is not None:
            rows.append(("RMS level (dBr)", [f"{self.ref + db(rms[i]):12.4f}" for i in range(n)]))
        with np.errstate(invalid="ignore", divide="ignore"):
            crest = [s["peak"][i] / rms[i] for i in range(n)]
        rows.append(("Crest factor (dB)", [f"{db(crest[i]):12.4f}" for i in range(n)]))
        rows.append(("Peak count", [f"{int(s['peak_count'][i]):12d}" for i in range(n)]))
        rows.append(("Peak sample", [f"{int(s['peak_frame'][i]):12d}" for i in range(n)]))
        rows.append(("Samples", [f"{samples:12d}" for _ in range(n)]))
        rows.append(("Length (s)", [f"{samples / self.ostream.fs:12.2f}" for _ in range(n)]))
        out = []
        for i0 in range(0, n, cols):
            for label, vals in rows:
                # C layout: "%-18s" then " %12..." per column (stats.c:170-249)
                out.append(f"{label:<18s}" + "".join(" " + v for v in vals[i0 : i0 + cols]))
            out.append("")
        log.info("\n" + "\n".join(out))


def stats_effect_init(ei, istream, selector, dir_, argv):
    name = argv[0]
    args = argv[1:]
    try:
        opts, ind = getopt(args, "w:i")
    except ParseError as e:
        raise EffectError(f"{name}: {e}")
    width = 80
    interp = False
    for opt, arg in opts:
        if opt == "w":
            if arg == "auto":
                width = -1
            else:
                v, rest = strtol(arg)
                if rest or v < 0:
                    raise EffectError(f"{name}: failed to parse width: {arg}")
                width = v
        elif opt == "i":
            interp = True
    ref = None
    if ind == len(args) - 1:
        # the reference parses argv[1] — the FIRST argument, even when it is
        # an option — as ref_level (stats.c:283-285), so `stats -i 3` fails
        # there; reproduce the quirk for behavior parity
        v, rest = strtod(args[0])
        if rest == args[0] or rest:
            raise EffectError(f"{name}: failed to parse ref_level: {args[0]}")
        ref = v  # printed as ref + dBFS (stats.c:186-188)
    elif ind != len(args):
        raise EffectError(f"{name}: usage: {ei.usage}")
    return StatsEffect(name, istream, selector, ref, width, interp)


register_effect("stats", "stats [-i] [-w cols] [ref_level]", stats_effect_init)
