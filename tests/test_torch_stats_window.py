"""A plain model of csrc/stats.cu's windowed walk for `stats -i` (K16), and
of csrc/tpdf.cu's reduced-tap error feedback (K15), held on the CPU, where
no kernel can run, bit for bit against the port's plain versions
(`_stats_interp_ref`, `_stats_interp_f32_ref`, `tpdf_dither_ref`,
`tpdf_dither_f32_ref`), which the other CPU tests hold against dsp_tpu.

The walk takes a channel's active samples 32 at a time (a warp's lanes):

1. gate closed (nctr = 0): each lane tests its sample against the
   thresholds, which cannot move while the gate is closed; the first
   trigger (a ballot) starts an open window there, none skips the window;
2. gate open: every lane assumes every sample of the window from its start
   is gated, and computes its sample's 64-slot buffer slots 0-3 as the
   nest of fused multiply-adds over the 16 gated inputs before it (the
   history, then the window's earlier lanes) down to the block's carried
   buffer or a zero slot, its y and its four parabola vertices (divided
   out only where a division-free bound lets a vertex cross the running min
   or max; the model checks the bound on every fit);
3. decide: the lanes' samples are gated by the trigger count alone until the
   first sample whose fits can be a new min or max (a ballot against the
   running min and max); that sample runs on its own, in order, and the
   ballots run again on the lanes after it;
4. close at the first sample the gate leaves (or at the window's end):
   carry y, nctr and the thresholds into the next window, and the window's
   gated inputs into the history of the last 16 gated inputs, from which
   (and the block's carried buffer) the 64 slots are built at the block's
   end.
"""

import math

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from dsp_tpu_torch.core.types import StreamInfo
from dsp_tpu_torch.effects.dither import DitherEffect
from dsp_tpu_torch.effects.stats import StatsEffect
from dsp_tpu_torch.ops import time_domain as td
from dsp_tpu_torch.ops.time_domain import _fma, _fma32_np

FS = 44100
C = 2
WARP = 32
DELAY = td.STATS_INTERP_DELAY


# --- exact fused multiply-adds on numpy arrays --------------------------------


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    t = 134217729.0 * a  # 2^27 + 1: Veltkamp's split into 26- and 27-bit halves
    hi = t - (t - a)
    return hi, a - hi


def _fma64(a, b, c):
    """a·b + c rounded once, float64 arrays (Boldo and Melquiond's emulation:
    the exact product and sum, the low parts added with rounding to odd,
    one rounding to nearest); an exact zero takes IEEE's sign as _fma does."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, dtype=np.float64) for v in (a, b, c)))
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    v, err = _two_sum(tl, e)
    odd = (err != 0) & ((v.view(np.int64) & 1) == 0)
    v = np.where(odd, np.nextafter(v, np.copysign(np.inf, err)), v)
    r = th + v
    return np.where(r == 0, p + c, r)


def _fma_t(a, b, c, f32):
    """a·b + c rounded once in float64 or float32 (numpy arrays)."""
    if not f32:
        return _fma64(a, b, c)
    return _fma32_np(*np.broadcast_arrays(*(np.asarray(v, dtype=np.float32) for v in (a, b, c))))


def _bits_equal(a, b):
    """Equal dtype, shape and bits (-0.0 and +0.0 differ, NaNs compare)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.float64: torch.int64, torch.float32: torch.int32}.get(a.dtype)
    return torch.equal(a.view(view), b.view(view)) if view else torch.equal(a, b)


def test_fma64_is_exact():
    rng = np.random.default_rng(7)
    a = rng.standard_normal(4000) * 10.0 ** rng.integers(-8, 3, 4000)
    b = rng.standard_normal(4000)
    c = np.concatenate([rng.standard_normal(2000) * 1e-3, -a[2000:] * b[2000:]])
    c[::7] = 0.0
    c[1::7] = -0.0
    got = _fma64(a, b, c)
    want = np.array([_fma(*v) for v in zip(a.tolist(), b.tolist(), c.tolist())])
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


# --- the window model -------------------------------------------------------


def _fits(y, f32):
    """The four parabola fits of each lane's y [6, L]: skip [4, L] and the
    vertices yq [4, L], as stats.py:222-250 computes them."""
    T = np.float32 if f32 else np.float64
    skip, yq = [], []
    for i in range(1, 5):
        d0 = y[i] - y[i - 1]
        d1 = y[i] - y[i + 1]
        skip.append(((d0 > 0) & (d1 < 0)) | ((d0 < 0) & (d1 > 0)) | ((d0 == 0) & (d1 == 0)))
        dy = y[i - 1] - y[i + 1]
        den = (y[i - 1] - T(2.0) * y[i]) + y[i + 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            p4 = dy / (T(8.0) * np.where(den == 0, T(1.0), den))
        yq.append(_fma_t(-dy, p4, y[i], f32))
    return np.array(skip), np.array(yq, dtype=T)


def _may_cross(y, mn, mx, f32):
    """[4, L]: whether each fit's vertex can be a new min or max, without
    its division (csrc/stats.cu's may_cross): |yq - y_i| is at most
    dy²/(8|den|)(1+u)² + u|y_i|, tested in float64 with a slack of 2^-20;
    true outside the ranges where the products and the roundings are safe
    (|y_i| below 1e-290, float32 1e-30), on a NaN and where den is 0."""
    u, s = (2.0 ** -24 if f32 else 2.0 ** -53), 2.0 ** -20
    out = []
    for i in range(1, 5):
        dy = (y[i - 1] - y[i + 1]).astype(np.float64)
        den = ((y[i - 1] - y[i].dtype.type(2.0) * y[i]) + y[i + 1]).astype(np.float64)
        a, b, c = np.abs(dy), np.abs(den), y[i].astype(np.float64)
        tiny = 1e-30 if f32 else 1e-290
        ok = ((a >= 1e-140) & (a <= 1e140) & (b >= 1e-280) & (b <= 1e280) & (np.abs(c) >= tiny)
              & (np.abs(c) <= 1e280))
        with np.errstate(over="ignore", invalid="ignore"):
            lhs = a * a * (1.0 + s) + 8.0 * b * (4.0 * u * np.abs(c))
            rhs = 8.0 * b * (1.0 - s)
            inside = ((float(mx) - c) * rhs > lhs) & ((c - float(mn)) * rhs > lhs)
        out.append(~ok | ~inside)
    return np.array(out)


def _event(st, yq, skip, t, f32):
    """One gated sample's four fits in order (the serial part of stats.c's
    stats_interp_peak): min, max, thresholds, peak, count and frame."""
    T = np.float32 if f32 else np.float64
    r = 0
    for i in range(4):
        if skip[i]:
            continue
        v = yq[i]
        if v <= st["mn"]:
            st["mn"], st["tmin"] = v, T(0.5) * v
        elif v >= st["mx"]:
            st["mx"], st["tmax"] = v, T(0.5) * v
        else:
            continue
        a = abs(v)
        if a > st["pk"]:
            st["pk"], r = a, 2
        elif a > 0 and a == st["pk"]:
            r = 1
    if r == 2:
        st["frm"], st["cnt"] = t - (DELAY - 1), 1
    elif r == 1:
        st["cnt"] += 1


def _window_channel(seq, n_act, s0, st, H, c3, f32, trace):
    """The walk over one channel's n_act samples. seq: the carried z then
    the samples; st: the channel's scalars, its carried M [64] and y [6].
    The walk keeps the last 16 gated inputs (gh, the latest last) and their
    count since the block began (tg, at most 16) instead of M, and builds M
    from them at the end."""
    T = np.float32 if f32 else np.float64
    zero = T(0.0)
    M0 = st["M"]
    gh, tg = np.zeros(16, dtype=T), 0
    p = 0
    while p < n_act:
        L = min(WARP, n_act - p)
        lanes = np.arange(L)
        sv = seq[p + 9:p + 9 + L]
        if st["nc"] == 0:
            trig = (sv < st["tmin"]) | (sv > st["tmax"])
            if not trig.any():
                trace["skipped"] += L
                p += L
                continue
            p += int(np.argmax(trig))
            L = min(WARP, n_act - p)
            lanes = np.arange(L)
            sv = seq[p + 9:p + 9 + L]
        trace["open"] += 1
        xw = seq[p:p + L]
        gx = np.concatenate([gh, xw])  # the history, then the window's inputs
        # 2. each lane's slots 0-3 before its sample, all gated from p: the
        # nest over the gated inputs before it, down to M0 or a zero slot
        g = tg + lanes
        Mb = np.zeros((4, L), dtype=T)
        for k in range(4):
            v = np.where(g < 16, M0[np.minimum(k + 4 * g, 63)], zero).astype(T)
            for i in range(15, -1, -1):
                xi = gx[16 + lanes - 1 - i]
                v = np.where(i < g, _fma_t(xi, H[k + 4 * i], v, f32), v).astype(T)
            Mb[k] = v
        y = np.empty((6, L), dtype=T)
        y[2] = _fma_t(c3[0], xw, Mb[0], f32)
        y[3] = _fma_t(c3[1], xw, Mb[1], f32)
        y[4] = _fma_t(c3[2], xw, Mb[2], f32)
        y[5] = Mb[3]
        y[0] = np.concatenate([[st["y"][4]], y[4][:-1]])
        y[1] = np.concatenate([[st["y"][5]], y[5][:-1]])
        skip, yq = _fits(y, f32)
        # the kernel divides only where the bound lets a vertex cross the
        # running min or max (and leaves NaN, which no compare takes,
        # elsewhere): the bound must never rule out a vertex that crosses
        need = ~skip & _may_cross(y, st["mn"], st["mx"], f32)
        crosses = ~skip & ((yq <= st["mn"]) | (yq >= st["mx"]))
        assert not (crosses & ~need).any(), "the division-free bound missed a crossing"
        trace["divided"] += int(need.any(axis=0).any())
        yq = np.where(need, yq, np.nan).astype(yq.dtype)
        # 3. decide
        q, nc_q = 0, st["nc"]
        while True:
            trig = (sv < st["tmin"]) | (sv > st["tmax"])
            t_mask = trig & (lanes >= q)
            last = np.maximum.accumulate(np.where(t_mask, lanes, -1))
            nc_before = np.where(last >= 0, DELAY - (lanes - last), nc_q - (lanes - q))
            gated = nc_before > 0
            off = np.flatnonzero(~gated & (lanes >= q))
            close = int(off[0]) if off.size else L
            cand = (~skip & ((yq <= st["mn"]) | (yq >= st["mx"]))).any(axis=0) & (lanes >= q)
            on = np.flatnonzero(cand)
            ev = int(on[0]) if on.size else L
            if ev < close:
                trace["events"] += 1
                _event(st, yq[:, ev], skip[:, ev], s0 + p + ev, f32)
                q, nc_q = ev + 1, int(nc_before[ev]) - 1
                if q == L:
                    close = L
                    break
                continue
            break
        G = close
        st["nc"] = int(nc_before[G - 1]) - 1 if G > q else nc_q
        # 4. close: y from the last gated lane; its inputs join the history
        st["y"] = y[:, G - 1].copy()
        gh = gx[G:G + 16].copy()
        tg = min(16, tg + G)
        p += G
    # M after the block's last gated sample
    slots = np.arange(64)
    nlev = 16 - slots // 4
    M = np.where(tg < nlev, M0[np.minimum(slots + 4 * tg, 63)], zero).astype(T)
    for i in range(15, -1, -1):
        use = i < np.minimum(tg, nlev)
        M = np.where(use, _fma_t(gh[15 - i], H[np.minimum(slots + 4 * i, 63)], M, f32), M).astype(T)
    st["M"] = M


def window_walk(s, xs, insert_h, trace=None):
    """The model: the -i leaves of stats_step_ref's result, from the window
    walk over each channel."""
    f32 = xs.dtype == torch.float32
    T = np.float32 if f32 else np.float64
    h = insert_h.numpy().astype(T)
    H, c3 = h[:64], h[64:]
    samples, limit = int(s["samples"]), int(s["limit"])
    B, n = xs.shape
    n_act = max(0, min(B, limit - samples))
    x = xs.numpy()
    out = {k: [] for k in ("m", "y", "z", "nctr", "tmin", "tmax", "min", "max", "peak",
                           "peak_count", "peak_frame")}
    trace = trace if trace is not None else {}
    for k in ("open", "events", "skipped", "divided"):
        trace.setdefault(k, 0)
    for c in range(n):
        seq = np.concatenate([s["z"][:, c].numpy(), x[:n_act, c]]).astype(T)
        st = {"M": s["m"][:, c].numpy().copy(), "y": s["y"][:, c].numpy().copy(),
              "nc": int(s["nctr"][c]), "tmin": T(s["tmin"][c]), "tmax": T(s["tmax"][c]),
              "mn": T(s["min"][c]), "mx": T(s["max"][c]), "pk": T(s["peak"][c]),
              "cnt": int(s["peak_count"][c]), "frm": int(s["peak_frame"][c])}
        _window_channel(seq, n_act, samples, st, H, c3, f32, trace)
        for k, v in (("m", st["M"]), ("y", st["y"]), ("z", seq[n_act:n_act + 9]),
                     ("nctr", st["nc"]), ("tmin", st["tmin"]), ("tmax", st["tmax"]),
                     ("min", st["mn"]), ("max", st["mx"]), ("peak", st["pk"]),
                     ("peak_count", st["cnt"]), ("peak_frame", st["frm"])):
            out[k].append(v)
    new = {}
    for k, v in out.items():
        arr = np.array(v, dtype=s[k].numpy().dtype)
        new[k] = torch.from_numpy(arr.T.copy() if arr.ndim == 2 else arr)
    return new


# --- inputs -----------------------------------------------------------------


def _signal(kind, B, blocks, rng):
    n = B * blocks
    t = np.arange(n) / FS
    if kind == "noise":
        x = np.round(rng.standard_normal((n, C)) * 0.3 * 32768) / 32768
    elif kind == "sines":
        x = np.stack([0.5 * np.sin(2 * np.pi * 997 * t), 0.4 * np.sin(2 * np.pi * 3001 * t + 1)], 1)
        x = np.round(x * 32768) / 32768
    elif kind == "gated":
        # loud, then -40 dB, then loud: the gate closes and reopens, also
        # inside a window (the edges fall off the 32-sample grid)
        x = rng.standard_normal((n, C)) * 0.3
        edges = [int(n * f) + o for f, o in ((0.2, 5), (0.35, 17), (0.55, 3), (0.7, 29))]
        g = np.ones(n)
        g[edges[0]:edges[1]] = 0.01
        g[edges[2]:edges[3]] = 0.01
        x = x * g[:, None]
    elif kind == "silence":
        x = np.zeros((n, C))
    elif kind == "click":
        x = np.zeros((n, C))
        x[n // 3 + 7, 0] = 0.9
        x[n // 3 + 40, 1] = -0.7
    return x.reshape(blocks, B, C)


def _run(kind, B, blocks, f32, limit=None, seed=0):
    rng = np.random.default_rng(seed)
    dt = torch.float32 if f32 else torch.float64
    e = StatsEffect("stats", StreamInfo(FS, C), np.ones(C, dtype=bool), None, 80, True)
    table = torch.as_tensor(e._insert_table, dtype=dt)
    st = {k: torch.as_tensor(v) for k, v in e.state0().items()}
    st = {k: v.to(dt) if v.is_floating_point() else v for k, v in st.items()}
    if limit is not None:
        st["limit"] = torch.tensor(limit, dtype=torch.int64)
    x = torch.as_tensor(_signal(kind, B, blocks, rng), dtype=dt)
    trace = {}
    for blk in range(blocks):
        want = td.stats_step_ref(st, x[blk], table)
        got = window_walk(st, x[blk], table, trace)
        for k, v in got.items():
            assert _bits_equal(v, want[k]), (kind, B, blk, k, v, want[k])
        st = want
    return st, trace


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["noise", "sines", "gated", "silence", "click"])
def test_window_walk_equals_plain_version(kind, f32):
    st, trace = _run(kind, 2048, 1, f32)
    if kind in ("noise", "sines"):
        assert trace["open"] > 0 and trace["events"] > 0
    if kind == "gated":
        assert trace["skipped"] > 0 and trace["open"] > 10, trace
    if kind == "silence":
        assert trace["open"] == 0 and int(st["peak_count"].sum()) == 0, trace


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("B", [1, 7, 1000])
def test_window_walk_block_sizes(B, f32):
    # three blocks with the state carried across; at B = 1 and 7 the gate
    # stays open across many block edges
    blocks = {1: 60, 7: 12, 1000: 3}[B]
    _run("gated" if B == 1000 else "noise", B, blocks, f32, seed=B)


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_window_walk_limit_inside_a_window(f32):
    # the third block's active samples end 13 samples into a window
    _run("noise", 2048, 3, f32, limit=2 * 2048 + 1000 + 13, seed=3)


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_window_walk_carries_an_open_gate_across_blocks(f32):
    # a click 5 samples before a block edge: nctr is open at the edge
    rng = np.random.default_rng(11)
    dt = torch.float32 if f32 else torch.float64
    e = StatsEffect("stats", StreamInfo(FS, C), np.ones(C, dtype=bool), None, 80, True)
    table = torch.as_tensor(e._insert_table, dtype=dt)
    st = {k: torch.as_tensor(v) for k, v in e.state0().items()}
    st = {k: v.to(dt) if v.is_floating_point() else v for k, v in st.items()}
    x = rng.standard_normal((3 * 512, C)) * 1e-3
    x[512 - 5] = 0.8
    x[1024 - 2, 1] = -0.9
    x = torch.as_tensor(x, dtype=dt).reshape(3, 512, C)
    edges = []
    for blk in range(3):
        want = td.stats_step_ref(st, x[blk], table)
        got = window_walk(st, x[blk], table)
        for k in got:
            assert _bits_equal(got[k], want[k]), (blk, k)
        edges.append(want["nctr"].tolist())
        st = want
    assert any(v > 0 for v in edges[0]) and any(v > 0 for v in edges[1]), edges


# --- the dither's reduced-tap feedback ----------------------------------------


def _real_taps(fir):
    """The feedback's real tap count as csrc/tpdf.cu instantiates it: the
    last nonzero tap, rounded up to 1, 3, 5 or 9."""
    nz = np.flatnonzero(np.asarray(fir) != 0)
    last = int(nz[-1]) + 1 if nz.size else 1
    return next(n for n in (1, 3, 5, 9) if n >= last)


def _feedback(x, noise, ehist, fir, q0, q1, enabled, nt, f32):
    """The error-feedback quantizer summing only the first nt taps."""
    T = np.float32 if f32 else float
    B, n = x.shape
    out = np.array(x, copy=True)
    eh = np.array(ehist, copy=True)
    for c in range(n):
        e = [T(v) for v in eh[:, c]]
        taps = [T(v) for v in fir[:nt]]
        for b in range(B):
            fb = T(0.0)
            for t in range(nt):
                fb = fb + taps[t] * e[t]
            xn = T(x[b, c])
            p0 = xn - fb
            v = T(q0[c]) * (p0 + T(noise[b, c]))
            p1 = T(q1[c]) * (np.rint(v) if f32 else td._rint(v))
            e = [p1 - p0] + e[:-1]
            if enabled[c]:
                out[b, c] = p1
        eh[:, c] = e
    return eh, out


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", ["sloped", "sloped2", "lipshitz", "wan3", "wan9"])
@pytest.mark.parametrize("hist", ["zeros", "negzeros", "noise"])
def test_reduced_taps_equal_nine(shape, hist, f32):
    from dsp_tpu_torch.core import prng
    from dsp_tpu_torch.core.prng import PM_RAND_MAX

    rng = np.random.default_rng(5)
    fs = 48000 if shape.startswith("wan") else FS
    e = DitherEffect("dither", StreamInfo(fs, C), np.ones(C, dtype=bool), shape, 16.0, 16,
                     False, False, seed=99)
    dt = torch.float32 if f32 else torch.float64
    B = 300
    x = torch.as_tensor(rng.standard_normal((B, C)) * 0.3, dtype=dt)
    x[40:60] = 0.0
    ehist = {"zeros": np.zeros((9, C)), "negzeros": np.full((9, C), -0.0),
             "noise": rng.standard_normal((9, C)) * 1e-5}[hist]
    st = {k: torch.as_tensor(v) for k, v in e.state0().items()}
    args = [torch.as_tensor(v, dtype=None if v.dtype == bool else dt)
            for v in (e.n_mult, e.q_mult0, e.q_mult1, e.enabled, e.fir)]
    ins = (st["key"], x, torch.as_tensor(ehist, dtype=dt), st["nprev"].to(dt), *args)
    ref = td.tpdf_dither_f32_ref if f32 else td.tpdf_dither_ref
    _, eh_want, _, y_want = ref(*ins, e.mode)
    # the plain version's noise, drawn as it draws it
    keys = prng.split(st["key"], 3)
    uni = prng.uniform_f32 if f32 else prng.uniform_f64
    u1 = uni(keys[1], (B, C), PM_RAND_MAX)
    if e.mode == td.DITHER_SLOPED2:
        noise = (u1 - torch.cat([st["nprev"][None].to(dt), u1[:-1]])) * args[0]
    else:
        noise = (u1 - uni(keys[2], (B, C), PM_RAND_MAX)) * args[0]
    nt = _real_taps(e.fir)
    assert nt == {"sloped": 1, "sloped2": 1, "lipshitz": 5, "wan3": 3, "wan9": 9}[shape]
    eh, y = _feedback(x.numpy(), noise.numpy(), ehist.astype(np.float32 if f32 else np.float64),
                      args[4].numpy(), args[1].numpy(), args[2].numpy(), e.enabled, nt, f32)
    assert _bits_equal(torch.from_numpy(np.asarray(y)), y_want)
    assert _bits_equal(torch.from_numpy(np.asarray(eh)), eh_want)
    assert math.isfinite(float(y_want.abs().max()))
