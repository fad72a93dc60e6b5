"""matrix4 steering engine: control-rate event detection and matrix
computation (reference: matrix4_common.c/h), ported from
dsp_tpu.ops.m4_engine in float64.

The constants, parameter and state builders are host numpy, as in dsp_tpu,
so both packages start from the same state. The plain versions are torch
functions over a leading lane axis ``[S]`` (streams x bands; matrix4 runs
one lane), with the reference's branches as ``torch.where``, its ring
buffers as ``[S, L, ...]`` state with an integer pointer, and the
slope-lookback walk as a masked cumulative AND followed by the C-ordered
masked EWMA replay. Three kernels run them on the card:

* ``m4_env`` (K11, csrc/m4_env.cu): the eight envelope EWMAs of the
  band-limited pair, decimated to the fs/32 ticks;
* ``m4_event`` (K9 + K10, csrc/m4_event.cu): the event engine tick by
  tick, one block a lane, in three overlapped roles over chunks of ticks
  (``event_geometry``): a warp computes the decision-free part of each
  tick ahead of the chain, one thread runs the decisions, and two warps run
  the background-weight smoother, the fade, the contour gains, the matrix
  coefficients, the phase flip and the direct pan, and the parabolic
  interpolator's coefficient sets, a chunk behind (the whole block takes
  the first chunk's pre-phase and the last chunk's epilogue);
* ``m4_audio`` (K12 + K13, csrc/m4_audio.cu): the interpolated matrix
  values, the lookahead-delayed 2 -> 4 matrix, the dynamic shelf and
  lowpass, the phase-flip allpasses and the output columns.

matrix4_mb runs 13 engines, one a band, whose event thresholds the bands
modulate together every tick (``mb_threshold_ref``), on three more:

* ``m4mb_env`` (K11 over lanes, csrc/m4_env.cu): the frequency-mask mix
  and the envelopes of the 13 bands;
* ``m4mb_event`` (K9 + K10, csrc/m4_event.cu): the 13 coupled engines in
  one warp, with the same roles around them, and matrix4_mb's epilogue and
  interpolator insert;
* ``m4mb_audio`` (K12 + K13, csrc/m4mb_audio.cu): the delayed bands
  through their matrices, the 26 phase-flip allpasses, the band sums and
  the direct path.

Each wrapper takes CUDA tensors (or raises) and counts its launches; a CPU
tensor runs ``<name>_ref``.

The stream axis (batched processing, ``CompiledChain.process_batch``): each
wrapper also takes S independent streams, every tensor with a leading S
(matrix4's streams are ``m4_event``'s lanes; matrix4_mb's a leading S before
the 13 bands), and runs them in the launch of one, each stream with a
one-stream launch's partition and order, so its bits. The plain versions
run the streams one at a time, so that on the CPU each stream is a
one-stream call bit for bit. dsp_tpu's f64 path is plain jnp (dfx's f64
branches pass straight through: atan_pos is arctan), so the plain versions
are plain torch; the two-float32 machinery is not ported.

Under float32 dsp_tpu runs the whole control path of both upmixes in
two-float32 (dfx.DF: its add, multiply, divide, sqrt, sin, cos, tan, exp and
atan_pos, dfx.py:113-520, under env_ewma_scan(..., df=True) and event_step
with cast_params(df=True)), and the audio path in float32. Each wrapper has
a float32 form (``<name>_f32``) that reads float32, computes the float64
function above in float64 registers and stores float32: a float32 (hi, lo)
pair is read as hi + lo, and a state leaf that dsp_tpu keeps as a pair
(``ev``/``ev_lo``, ``env_m``/``env_m_lo``, ``bg_cs``/``bg_cs_lo``,
``ev_thresh``/``ev_thresh_lo``) is written back split, hi = float32(v),
lo = float32(v - hi). The envelopes at the ticks stay float64 (control-rate
scratch); the per-tick matrix values are rounded to float32 where dsp_tpu
collapses its pairs, so the coefficient sets, the window and the display
values are float32, as dsp_tpu's are. The plain float32 forms run the
float64 plain versions on the upcast inputs and round the same way.
"""

import ctypes
import math

import numpy as np
import torch

from dsp_tpu_torch.ops.fft_conv import (SMEM_LIMIT, _check_cuda, _check_dtypes, _stack_tree,
                                        each_stream)
from dsp_tpu_torch.ops.iir import split_f64

EVENT_THRESH = 1.8
EVENT_END_THRESH = 0.2
ENV_SMOOTH_TIME = 30.0
EVENT_SMOOTH_TIME = 30.0
ACCOM_TIME = 300.0
RISE_TIME_FAST = 30.0
RISE_TIME_SLOW = 100.0
NORM_TIME = 160.0
NORM_CROSSFEED = 0.1
ORD_FACTOR_DECAY = 10.0
EVENT_SAMPLE_TIME = 30.0
EVENT_MAX_HOLD_TIME = 200.0
EVENT_MIN_HOLD_TIME = 50.0
EVENT_MASK_TIME = 100.0
ORD_SENS_ERR = 2.0
ORD_SENS_WEIGHT = 3.0
ORD_WEIGHT_THRESH = 0.3
ORD_NOTCH_FREQ_1 = 4.0
ORD_NOTCH_GAIN_1 = -10.3
ORD_NOTCH_FREQ_2 = 12.0
ORD_NOTCH_GAIN_2 = -10.3
ORD_NOTCH_SCALE_RT = 2.0
DIFF_SENS_WEIGHT = 2.0
DIFF_WEIGHT_SCALE = 2.5
ORD_DPWR_SENS_ERR = 8.0
PWRCMP_RISE_TIME = 100.0
PWRCMP_FALL_TIME = 15.0
PWRCMP_FACTOR_SENS = 0.2
NORM_ACCOM_FACTOR = 0.9
DIFF_OVERSHOOT = 1.001
DOWNSAMPLE_FACTOR = 32

M_PI_4 = float(np.pi / 4.0)
M_PI_2 = float(np.pi / 2.0)
# dsp_tpu guards divisions with float32's smallest normal (its f32 path
# needs a guard both dtypes hold); the port keeps the same value
DBL_MIN = float(np.finfo(np.float32).tiny)


def ewma_g(fs, tc_ms):
    """EWMA gain for a 10-90% rise time in ms (ewma.h:28-35)."""
    tc = tc_ms / 1000.0 / 2.1972
    return 1.0 - np.exp(-1.0 / (fs * tc))


def time_to_frames(ms, fs):
    # lround (half away from zero), NOT Python round (banker's): 22.5 must
    # become 23 like the C TIME_TO_FRAMES at fs=48000 (matrix4_common.h)
    return int(math.floor(ms / 1000.0 * fs + 0.5))


def svf_pk_params(fs, f0, q, g0):
    w0 = 2 * np.pi * f0 / fs
    return {
        "a0": 10.0 ** (g0 / 40.0),
        "alpha": np.sin(w0) / (2.0 * q),
        "beta": np.cos(w0) - 1.0,
    }


def make_event_params(fs_ds, base_thresh_scale=1.0, base_ord_notch_scale=0.7,
                      rear_ev_mask=1.0, norm_accom_factor=NORM_ACCOM_FACTOR,
                      diff_overshoot=DIFF_OVERSHOOT):
    """Static parameter dict (event_state_init_priv / event_config_init_priv)."""
    from dsp_tpu_torch.effects.biquad import LOWPASS, design, normalize

    p = {}
    p["g_accom"] = ewma_g(fs_ds, ACCOM_TIME)
    p["g_norm"] = ewma_g(fs_ds, NORM_TIME)
    p["g_norm_fast"] = ewma_g(fs_ds, NORM_TIME * 0.625)
    p["g_slow"] = ewma_g(fs_ds, RISE_TIME_SLOW)
    p["g_smooth"] = ewma_g(fs_ds, EVENT_SMOOTH_TIME)
    p["g_avg"] = ewma_g(fs_ds, EVENT_SAMPLE_TIME)
    p["g_drift_slow"] = ewma_g(fs_ds, ACCOM_TIME * 2.0)
    p["g_drift_fast"] = ewma_g(fs_ds, RISE_TIME_FAST)
    p["g_dpwr_slow"] = ewma_g(fs_ds, ACCOM_TIME * 0.5)
    p["g_dpwr_fast"] = ewma_g(fs_ds, RISE_TIME_FAST)
    p["g_ds0"] = ewma_g(fs_ds, RISE_TIME_FAST)
    p["g_ds1"] = ewma_g(fs_ds, RISE_TIME_FAST * 0.3)
    p["g_pwrcmp"] = ewma_g(fs_ds, PWRCMP_RISE_TIME)
    p["g_ord_notch_scale"] = ewma_g(fs_ds, ORD_NOTCH_SCALE_RT * 1000.0)
    p["base_ord_ns"] = base_ord_notch_scale
    c = normalize(*design(LOWPASS, fs_ds, (0.34 * 1000 * 1.5) / RISE_TIME_FAST, 0.577))
    p["ord_lp_c"] = np.array(c)
    p["svf1"] = svf_pk_params(fs_ds, ORD_NOTCH_FREQ_1, 0.5, ORD_NOTCH_GAIN_1)
    p["svf2"] = svf_pk_params(fs_ds, ORD_NOTCH_FREQ_2, 0.5, ORD_NOTCH_GAIN_2)
    p["buf_len"] = time_to_frames(EVENT_SAMPLE_TIME * 0.5, fs_ds)
    p["clip_thresh"] = EVENT_THRESH * base_thresh_scale * 100.0
    p["pcf_sens"] = PWRCMP_FACTOR_SENS / base_thresh_scale
    p["sample_frames"] = time_to_frames(EVENT_SAMPLE_TIME, fs_ds)
    p["max_hold_frames"] = time_to_frames(EVENT_MAX_HOLD_TIME, fs_ds)
    p["min_hold_frames"] = time_to_frames(EVENT_MIN_HOLD_TIME, fs_ds)
    p["ord_factor_c"] = np.exp(-1.0 / (fs_ds * ORD_FACTOR_DECAY))
    p["diff_lim"] = M_PI_4 * diff_overshoot
    p["rear_ev_mask"] = rear_ev_mask
    p["accom_mask_fall"] = ACCOM_TIME / EVENT_MASK_TIME
    p["norm_accom_factor"] = norm_accom_factor
    p["base_thresh_scale"] = base_thresh_scale
    return p


def make_event_state(p):
    """Initial state dict (numpy float64 scalars/arrays)."""
    L = p["buf_len"]
    z = np.float64(0.0)
    st = {
        "sample": np.bool_(False),
        "hold": np.bool_(False),
        "f1_l": np.bool_(False), "f1_r": np.bool_(False),
        "f1_use_ord": np.bool_(False), "f1_fuse": np.bool_(False),
        "f0_l": np.bool_(False), "f0_r": np.bool_(False),
        "f0_use_ord": np.bool_(False), "f0_fuse": np.bool_(False), "f0_end": np.bool_(False),
        "accom": np.zeros(6),
        "norm": np.zeros(4),
        "slow": np.zeros(2),
        "smooth": np.zeros(2),
        "avg": np.zeros(4),
        "drift": np.zeros(4),
        "drift_dpwr": np.zeros(4),
        "drift_scale": np.array([1.0, 0.0]),
        "pwrcmp_factor": z,
        "ord_notch_scale": np.float64(1.0),
        "ord_lp_m": np.zeros((2, 2)),
        "svf_m": np.zeros((4, 2)),
        "dir_lr": z, "dir_cs": z,
        "ord_buf": np.zeros((L, 2)),
        "ord_lp_buf": np.zeros((L, 2)),
        "diff_buf": np.zeros((L, 2)),
        "slope_buf": np.zeros((L, 2)),
        "ds_ord_buf": np.zeros(L),  # calloc'd in C (matrix4_common.c:421)
        "max_buf": np.zeros(L),
        "last": np.zeros(2),
        "slope_last": np.zeros(2),
        "diff_last": np.zeros(2),
        "max1": z, "max0": z,
        "ord_factor": z, "adj": np.float64(1.0), "ds_diff": z,
        "t": np.int64(0), "t_sample": np.int64(0), "t_hold": np.int64(-2),
        "buf_p": np.int64(0),
        "ord_count": np.int64(0), "diff_count": np.int64(0),
        "early_count": np.int64(0), "ignore_count": np.int64(0),
    }
    return st


def make_event_state_lo(p):
    """Zero lo-parts (float32) for every float leaf of make_event_state:
    dsp_tpu's float32 path carries them; its float64 path, and the port,
    carry them untouched."""
    st = make_event_state(p)
    return {
        k: np.zeros_like(np.asarray(v), dtype=np.float32)
        for k, v in st.items()
        if np.issubdtype(np.asarray(v).dtype, np.floating)
    }


# --- plain versions over the lane axis ----------------------------------------


def smoothstep(x):
    x = torch.clamp(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def _ewma(m, s, g):
    return m + g * (s - m)


def _ewma_scale(m, s, g, sf):
    gs = torch.clamp(g * sf, max=0.39)
    return m + gs * (s - m)


def _ewma_set_max(m, s, g):
    """ewma_run_set_max: smooth upward, jump down (ewma.h:56-61).
    Returns (new_m, output)."""
    up = _ewma(m, s, g)
    new_m = torch.where(s >= m, up, s)
    return new_m, new_m


def _ewma_scale_asym(m, s, g, rise_sf, fall_sf):
    sf = torch.where(s >= m, torch.full_like(s, rise_sf), torch.full_like(s, fall_sf))
    return _ewma_scale(m, s, g, sf)


def calc_lr(n, d, expr):
    angle = torch.where((n < DBL_MIN) & (d < DBL_MIN), M_PI_4,
                        torch.where(d < DBL_MIN, M_PI_2, torch.atan(expr)))
    return angle - M_PI_4


calc_cs = calc_lr


def _norm_axes(lr, cs):
    abs_sum = lr.abs() + cs.abs()
    norm = torch.where(abs_sum > M_PI_4, M_PI_4 / torch.clamp(abs_sum, min=DBL_MIN), 1.0)
    return lr * norm, cs * norm


def _drift_err_scale(lr0, cs0, lr1, cs1, sens_err):
    lr_err = (lr1 - lr0).abs() * float(2.0 / np.pi)
    cs_err = (cs1 - cs0).abs() * float(2.0 / np.pi)
    return 1.0 + (lr_err + cs_err) * sens_err


def _ord_notch_scale(lr, cs):
    z = torch.clamp((lr.abs() + cs.abs()) * (2.0 / M_PI_4) - 1.0, min=0.0)
    return 1.0 - z * z * 0.99


def svf_pk_run(p, m0, m1, s, scale):
    alpha, beta = p["alpha"], p["beta"]
    a = (p["a0"] - 1.0) * scale + 1.0
    k0 = a * alpha
    k1 = a * beta
    g0 = 1.0 / (alpha + a)
    g1 = a / (k1 - alpha)
    c1 = 2.0 * g0 * (alpha - k1)
    c2 = g1 * beta
    d0 = g0 * a * (k0 + 1.0)
    d1 = g1 * (beta - k0)
    x = s - m0 - m1
    y = d0 * x + d1 * m0 + m1
    m1 = m1 + c2 * m0
    m0 = m0 + c1 * x
    return m0, m1, y


def smf_asym_run(st, s, g0, c0, c1):
    """Simper dynamic smoother (smf.h:58-71). st = (m0, m1)."""
    m0, m1 = st
    cc = torch.where(s > m1, torch.full_like(s, c0), torch.full_like(s, c1))
    g = torch.clamp(g0 + cc * (m0 - m1).abs(), max=0.39)
    m0 = m0 + g * (s - m0)
    m1 = m1 + g * (m0 - m1)
    return (m0, m1), m1


def host_params(p):
    """make_event_params' numpy scalars as Python floats and ints (dicts
    and the ord_lp_c array kept as their values)."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = host_params(v)
        elif isinstance(v, np.ndarray):
            out[k] = [float(a) for a in v]
        elif isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            out[k] = int(v)
        else:
            out[k] = float(v)
    return out


def _at(buf, lanes, idx):
    """buf[s, idx[s]] for every lane s."""
    return buf[lanes, idx]


def _set(buf, lanes, idx, val):
    out = buf.clone()
    out[lanes, idx] = val
    return out


def _lanes(v, like):
    """A parameter as `like` [S, 2]: a float everywhere, or a [S] tensor (a
    value a lane) along the lane axis."""
    if isinstance(v, torch.Tensor):
        return v[:, None].expand_as(like)
    return torch.full_like(like, v)


def event_step(p, st, env, pwr_env, thresh_scale=1.0):
    """One control-rate step (process_events_priv) of S lanes at once.

    p: host_params of make_event_params, where base_ord_ns, clip_thresh and
    pcf_sens may be [S] tensors (matrix4_mb's bands differ in them); st: the
    state dict with a leading lane axis on every leaf; env, pwr_env: dicts
    with l, r, sum, diff of shape [S]; thresh_scale: a float or a [S]
    tensor (matrix4_mb's modulated thresholds). Returns (st', outputs)
    with outputs ax_lr, ax_cs, ax_ev_lr, ax_ev_cs, ax_dpwr_lr, ax_dpwr_cs,
    pwrcmp_factor, hold. The arithmetic is dsp_tpu's, operation for
    operation."""
    s = dict(st)
    L = p["buf_len"]
    bp = st["buf_p"]
    S = bp.shape[0]
    lanes = torch.arange(S, device=bp.device)

    # the pairs run as columns of [S, 2]: (lr, cs) for the axes, (l, r) for
    # the channels; every element sees dsp_tpu's operations
    num = torch.stack([env["l"], env["sum"]], -1)
    den = torch.stack([env["r"], env["diff"]], -1)
    ords = calc_lr(num, den, num / den)  # ord_lr, ord_cs
    c = p["ord_lp_c"]
    lp_m = st["ord_lp_m"]
    ord_lp = c[0] * ords + lp_m[..., 0]  # the control-rate lowpass, TDF2
    s["ord_lp_m"] = torch.stack([lp_m[..., 1] + c[1] * ords - c[3] * ord_lp,
                                 c[2] * ords - c[4] * ord_lp], -1)
    ord_lp_d = _at(st["ord_lp_buf"], lanes, bp)  # delayed, [S, 2]
    ord_ns = (st["ord_notch_scale"] * p["base_ord_ns"])[:, None]
    svf = st["svf_m"]  # rows 0, 1: the first notch of lr, cs; rows 2, 3: the second
    m0a, m1a, y = svf_pk_run(p["svf1"], svf[:, 0:2, 0], svf[:, 0:2, 1], ord_lp_d, ord_ns)
    m0b, m1b, notched = svf_pk_run(p["svf2"], svf[:, 2:4, 0], svf[:, 2:4, 1], y, ord_ns)
    s["svf_m"] = torch.stack([torch.cat([m0a, m0b], 1), torch.cat([m1a, m1b], 1)], -1)

    pw4 = torch.stack([pwr_env["l"], pwr_env["r"], pwr_env["sum"], pwr_env["diff"]], -1)
    ac = st["accom"]
    ac03, out4 = _ewma_set_max(ac[:, :4], pw4, p["g_accom"])
    adapt = pw4 - out4
    an, ad = adapt[:, 0::2], adapt[:, 1::2]  # (l, sum) over (r, diff)
    diffs = calc_lr(an, ad, torch.sqrt((an / ad).abs()))  # diff_lr, diff_cs

    s["ord_buf"] = _set(st["ord_buf"], lanes, bp, ords)
    s["ord_lp_buf"] = _set(st["ord_lp_buf"], lanes, bp, ord_lp)
    s["diff_buf"] = _set(st["diff_buf"], lanes, bp, diffs)

    adj = torch.clamp(1.0 - st["ord_factor"] / 20.0, min=0.5)
    s["adj"] = adj
    s["ord_factor"] = st["ord_factor"] * p["ord_factor_c"]

    thresh = EVENT_THRESH * thresh_scale
    pw2 = pw4[:, :2]  # l, r
    pwr_xf = pw2 * (1.0 - NORM_CROSSFEED) + pw2.flip(-1) * NORM_CROSSFEED
    nrm = st["norm"]
    n23 = _ewma(nrm[:, 2:], pwr_xf, p["g_norm_fast"])
    n01 = _ewma(nrm[:, :2], (pwr_xf - n23 * p["norm_accom_factor"] * adj[:, None]).abs(),
                p["g_norm"])
    s["norm"] = torch.cat([n01, n23], -1)
    ac45 = _ewma_scale_asym(ac[:, 4:], pw2, p["g_accom"], 1.0, p["accom_mask_fall"])
    s["accom"] = torch.cat([ac03, ac45], -1)
    mask = torch.clamp(pw2 - ac45, min=0.0)
    clip = _lanes(p["clip_thresh"], mask)
    mask_norm = torch.where(n01 >= DBL_MIN, mask / n01, torch.where(mask < DBL_MIN, 0.0, clip))
    sm = _ewma(st["smooth"], torch.minimum(mask_norm, clip), p["g_smooth"])
    sl = _ewma(st["slow"], sm, p["g_slow"])
    s["smooth"], s["slow"] = sm, sl
    events = (sm - sl) * adj[:, None]
    slopes = events - st["last"]
    s["last"], s["slope_last"], s["diff_last"] = events, slopes, diffs
    s["slope_buf"] = _set(st["slope_buf"], lanes, bp, slopes)
    ord_lr, ord_cs = ords[:, 0], ords[:, 1]
    diff_lr, diff_cs = diffs[:, 0], diffs[:, 1]
    sm0, sm1 = sm[:, 0], sm[:, 1]
    l_event, r_event = events[:, 0], events[:, 1]
    l_slope, r_slope = slopes[:, 0], slopes[:, 1]
    max_d = _at(st["max_buf"], lanes, bp)
    s["max_buf"] = _set(st["max_buf"], lanes, bp, torch.maximum(l_event, r_event))
    s["pwrcmp_factor"] = _ewma_scale_asym(
        st["pwrcmp_factor"], 1.0 - smoothstep(max_d * p["pcf_sens"]), p["g_pwrcmp"],
        1.0, PWRCMP_RISE_TIME / PWRCMP_FALL_TIME,
    )

    # --- event sampling trigger (matrix4_common.c:567-609) ---
    trigger = (~st["sample"]) & (
        ((l_slope > 0.0) & (l_event > thresh)) | ((r_slope > 0.0) & (r_event > thresh))
    )
    new_f1_l = l_event >= r_event
    new_f1_r = r_event >= l_event
    fresh = (st["t"] - st["t_hold"]) > 1
    tr_fresh = trigger & fresh
    tr_fuse = trigger & ~fresh

    # lookback: count how far back the slope keeps increasing (bounded by L)
    sb = s["slope_buf"]
    sel_slope = torch.where(
        (new_f1_l & ~new_f1_r)[:, None], sb[:, :, 0],
        torch.where((new_f1_r & ~new_f1_l)[:, None], sb[:, :, 1], sb[:, :, 0] + sb[:, :, 1]),
    )  # [S, L]
    j_idx = torch.arange(1, L, device=bp.device)
    i_pos = (bp[:, None] - 1 - (j_idx - 1)) % L
    k_pos = (bp[:, None] - (j_idx - 1)) % L
    inc = sel_slope.gather(1, i_pos) > sel_slope.gather(1, k_pos)
    steps = torch.cumprod(inc.long(), dim=1).sum(dim=1)  # backward steps taken
    lb_start = (bp - steps) % L

    # averaging seed + the C-ordered masked EWMA replay over the lookback
    # region (a closed form rounds otherwise and flips decisions; see
    # dsp_tpu/ops/m4_engine.py:532-538). Its result is used only where a
    # fresh event starts, so lanes without one skip it.
    ords_diffs = torch.cat([ords, diffs], -1)  # ord_lr, ord_cs, diff_lr, diff_cs
    avg_seeded = ords_diffs
    if bool(tr_fresh.any()):
        rings = torch.cat([s["ord_buf"], s["diff_buf"]], dim=2)  # [S, L, 4]
        for j in range(L):
            idx = (lb_start + j) % L
            upd = _ewma(avg_seeded, rings[lanes, idx], p["g_avg"])
            avg_seeded = torch.where((j < steps)[:, None], upd, avg_seeded)

    s["sample"] = torch.where(trigger, True, st["sample"])
    s["f1_l"] = torch.where(trigger, new_f1_l, st["f1_l"])
    s["f1_r"] = torch.where(trigger, new_f1_r, st["f1_r"])
    s["f1_use_ord"] = torch.where(trigger, False, st["f1_use_ord"])
    s["f1_fuse"] = torch.where(trigger, tr_fuse, st["f1_fuse"])
    s["t_sample"] = torch.where(
        tr_fresh, st["t"] - steps,
        torch.where(tr_fuse, st["t"] - p["sample_frames"] // 2, st["t_sample"]))
    s["max1"] = torch.where(tr_fresh, 0.0, st["max1"])
    s["avg"] = torch.where(tr_fresh[:, None], avg_seeded, st["avg"])

    # --- sampling phase (matrix4_common.c:611-657) ---
    in_sample = s["sample"]
    av = s["avg"]
    av = torch.where(in_sample[:, None], _ewma(av, ords_diffs, p["g_avg"]), av)
    s["avg"] = av
    s["max1"] = torch.where(in_sample, torch.maximum(s["max1"], torch.maximum(l_event, r_event)),
                            s["max1"])
    sample_done = in_sample & ((st["t"] - s["t_sample"]) >= p["sample_frames"])
    use_ord = (av[:, 2].abs() + av[:, 3].abs()) > p["diff_lim"]
    f1_use_ord = torch.where(sample_done, s["f1_use_ord"] | use_ord, s["f1_use_ord"])
    ignore1 = sample_done & s["f1_fuse"] & f1_use_ord & ~st["f0_use_ord"]
    ignore2 = (
        sample_done & ~ignore1
        & (p["rear_ev_mask"] > 0.0) & (av[:, 3] < -M_PI_4 / 12)
        & ((s["f1_l"] & (l_event < thresh * p["rear_ev_mask"]))
           | (s["f1_r"] & (r_event < thresh * p["rear_ev_mask"])))
    )
    accept = sample_done & ~ignore1 & ~ignore2
    s["sample"] = torch.where(sample_done, False, s["sample"])
    s["f1_use_ord"] = f1_use_ord
    s["ignore_count"] = st["ignore_count"] + (ignore1 | ignore2).long()
    s["hold"] = torch.where(accept, True, st["hold"])
    s["t_hold"] = torch.where(accept, st["t"], st["t_hold"])
    dir_lr_new = torch.where(f1_use_ord, av[:, 0], av[:, 2])
    dir_cs_new = torch.where(f1_use_ord, av[:, 1], av[:, 3])
    s["dir_lr"] = torch.where(accept, dir_lr_new, st["dir_lr"])
    s["dir_cs"] = torch.where(accept, dir_cs_new, st["dir_cs"])
    s["ord_factor"] = s["ord_factor"] + (accept & f1_use_ord).to(s["ord_factor"].dtype)
    s["ord_count"] = st["ord_count"] + (accept & f1_use_ord & ~s["f1_fuse"]).long()
    s["diff_count"] = st["diff_count"] + (accept & ~f1_use_ord & ~s["f1_fuse"]).long()
    s["f0_l"] = torch.where(accept, s["f1_l"], st["f0_l"])
    s["f0_r"] = torch.where(accept, s["f1_r"], st["f0_r"])
    s["f0_use_ord"] = torch.where(accept, f1_use_ord, st["f0_use_ord"])
    s["f0_fuse"] = torch.where(accept, s["f1_fuse"], st["f0_fuse"])
    s["f0_end"] = torch.where(accept, False, st["f0_end"])
    s["max0"] = torch.where(accept, s["max1"], st["max0"])
    ds_diff_new = 1.0 + smoothstep((s["max1"] - thresh) / (thresh * DIFF_WEIGHT_SCALE)) * DIFF_SENS_WEIGHT
    s["ds_diff"] = torch.where(accept, ds_diff_new, st["ds_diff"])
    ds1 = torch.where(accept, ds_diff_new * 0.25, st["drift_scale"][:, 1])

    # --- hold / drift phase (matrix4_common.c:658-698) ---
    hold = s["hold"]
    dr = st["drift"]
    dp = st["drift_dpwr"]
    ds_diff_run = _ewma_scale(ds1, s["ds_diff"], p["g_ds1"], s["ds_diff"])
    dirs = torch.stack([s["dir_lr"], s["dir_cs"]], -1)
    dr_h = _ewma_scale(dr[:, 2:], dirs, p["g_drift_fast"], ds_diff_run[:, None])
    end_trig = ((s["f0_l"] & (sm0 <= EVENT_END_THRESH)) | (s["f0_r"] & (sm1 <= EVENT_END_THRESH)))
    f0_end = s["f0_end"] | (hold & end_trig)
    held_frames = st["t"] - s["t_hold"]
    release = hold & (
        ((held_frames >= p["min_hold_frames"]) & f0_end) | (held_frames >= p["max_hold_frames"])
    )
    s["early_count"] = st["early_count"] + (release & (held_frames < p["max_hold_frames"])).long()
    s["f0_end"] = f0_end
    dp_h = _ewma_scale(dp[:, 2:], dirs, p["g_dpwr_fast"], ds_diff_run[:, None])

    # non-hold path
    ds_ord_prev = _at(st["ds_ord_buf"], lanes, bp)
    ds_ord_in = _drift_err_scale(dr[:, 0], dr[:, 1], notched[:, 0], notched[:, 1],
                                 ORD_SENS_ERR) * ds_ord_prev
    ds0_new, ds_ord = _ewma_set_max(st["drift_scale"][:, 0], ds_ord_in, p["g_ds0"])
    dr_nh = _ewma_scale(dr[:, :2], notched, p["g_drift_slow"], ds_ord[:, None])
    ds_dpwr = _drift_err_scale(dp[:, 0], dp[:, 1], ord_lp[:, 0], ord_lp[:, 1], ORD_DPWR_SENS_ERR)
    dp_nh = _ewma_scale(dp[:, :2], ord_lp, p["g_dpwr_slow"], ds_dpwr[:, None])

    hold2, release2 = hold[:, None], release[:, None]
    ax = torch.where(hold2, dr_h, dr_nh)  # ax_lr, ax_cs
    ax_ev = torch.where(hold2, dr_h, 0.0)
    ax_dpwr = torch.where(hold2, dp_h, dp_nh)

    # on release: seed slow drift from the current axes
    s["drift"] = torch.cat([torch.where(release2, ax, torch.where(hold2, dr[:, :2], dr_nh)),
                            torch.where(hold2, dr_h, ax)], -1)
    # after each step dpwr[0]==dpwr[2] and dpwr[1]==dpwr[3]: the running pair
    # is copied into the other via ewma_set (matrix4_common.c:678-679,696-697)
    s["drift_dpwr"] = torch.cat([ax_dpwr, ax_dpwr], -1)
    s["drift_scale"] = torch.stack([
        torch.where(release, 1.0, torch.where(hold, st["drift_scale"][:, 0], ds0_new)),
        torch.where(hold, ds_diff_run, ds1),
    ], -1)
    s["hold"] = torch.where(release, False, s["hold"])

    ax_lr, ax_cs = ax[:, 0], ax[:, 1]
    ax_ev_lr, ax_ev_cs = ax_ev[:, 0], ax_ev[:, 1]
    ax_dpwr_lr, ax_dpwr_cs = ax_dpwr[:, 0], ax_dpwr[:, 1]
    ax_lr_n, ax_cs_n = _norm_axes(ax_lr, ax_cs)
    ax_dpwr_lr_n, ax_dpwr_cs_n = _norm_axes(ax_dpwr_lr, ax_dpwr_cs)
    ons_new, _ = _ewma_set_max(st["ord_notch_scale"], _ord_notch_scale(ax_lr_n, ax_cs_n),
                               p["g_ord_notch_scale"])
    s["ord_notch_scale"] = ons_new
    ds_ord_thresh = thresh * ORD_WEIGHT_THRESH
    x_w = (torch.maximum(sm0, sm1) - ds_ord_thresh) / (thresh * 1.5 - ds_ord_thresh)
    s["ds_ord_buf"] = _set(s["ds_ord_buf"], lanes, bp, torch.where(
        (sm0 > ds_ord_thresh) | (sm1 > ds_ord_thresh), smoothstep(x_w) * ORD_SENS_WEIGHT + 1.0, 1.0))
    s["t"] = st["t"] + 1
    s["buf_p"] = (bp + 1) % L

    out = {
        "ax_lr": ax_lr_n, "ax_cs": ax_cs_n,
        "ax_ev_lr": ax_ev_lr, "ax_ev_cs": ax_ev_cs,
        "ax_dpwr_lr": ax_dpwr_lr_n, "ax_dpwr_cs": ax_dpwr_cs_n,
        "pwrcmp_factor": s["pwrcmp_factor"],
        "hold": s["hold"],
    }
    return s, out


# --- matrix coefficient calculation (matrix4_common.c:715-978) ---


def _pwr_sum(a, b):
    return torch.sqrt(a * a + b * b)


def _input_phasors(ph_lr, ph_cs):
    """Complex input phasors for the dominant direction
    (matrix4_common.c:894-917)."""
    sin_lr = torch.sin(ph_lr + M_PI_4)
    cos_lr = torch.cos(ph_lr + M_PI_4)
    inside = (ph_lr.abs() + ph_cs.abs()) < M_PI_4
    ratio = torch.sin(2.0 * ph_cs) / torch.where(inside, torch.cos(2.0 * ph_lr), 1.0)
    alpha = torch.sqrt(torch.clamp(1.0 - ratio * ratio, min=0.0))
    beta = torch.sqrt(1.0 + alpha)
    gamma = torch.sqrt(torch.clamp(1.0 - alpha, min=0.0))
    neg = ph_cs < 0.0
    sin_theta_in = torch.where(neg, 0.5 * (beta + gamma), 0.5 * (beta - gamma))
    cos_theta_in = torch.where(neg, 0.5 * (beta - gamma), 0.5 * (beta + gamma))
    sin_theta = torch.where(inside, sin_theta_in, neg.to(sin_theta_in.dtype))
    cos_theta = torch.where(inside, cos_theta_in, (~neg).to(cos_theta_in.dtype))
    l_real = sin_lr * cos_theta
    l_imag = sin_lr * sin_theta
    r_real = cos_lr * cos_theta
    r_imag = cos_lr * -sin_theta
    return l_real, l_imag, r_real, r_imag


def calc_matrix_coefs_v1(ax_lr, ax_cs, dp_lr, dp_cs, surr_mult, surr_mult_rear, param,
                         shelf_args):
    """v1 matrix: no steering of rear-encoded signals."""
    lr, cs = ax_lr, ax_cs
    abs_lr = lr.abs()
    gl = 1.0 + torch.tan(abs_lr - M_PI_4)
    gc_2 = torch.where(cs > 0.0, 0.5 + 0.5 * torch.tan(cs - M_PI_4), 0.0)
    lsl = 1.0 - gc_2
    lsr = -gc_2
    rsl = lsr
    rsr = lsl
    cs_gl = torch.where(cs > -M_PI_4 / 2, 3.0 * cs, cs - M_PI_4)
    fa = torch.where(cs >= 0.0, 1.0, 1.0 + torch.sin(cs_gl))
    fb = torch.where(cs >= 0.0, 1.0, torch.cos(cs_gl))
    lsl = torch.where(lr > 0.0, lsl - gl * gl * fa, lsl)
    lsr = torch.where(lr > 0.0, lsr - gl * fb, lsr)
    rsl = torch.where(lr < 0.0, rsl - gl * fb, rsl)
    rsr = torch.where(lr < 0.0, rsr - gl * gl * fa, rsr)
    pu_sl = _pwr_sum(lsl, lsr)
    lsl = lsl / pu_sl
    lsr = lsr / pu_sl
    pu_sr = _pwr_sum(rsl, rsr)
    rsl = rsl / pu_sr
    rsr = rsr / pu_sr

    l_real, l_imag, r_real, r_imag = _input_phasors(dp_lr, dp_cs)
    gd_sl2 = (lsl * l_real + lsr * r_real) ** 2 + (lsl * l_imag + lsr * r_imag) ** 2
    gd_sr2 = (rsl * l_real + rsr * r_real) ** 2 + (rsl * l_imag + rsr * r_imag) ** 2
    pd_s = gd_sl2 + gd_sr2

    surr_mult2 = surr_mult * surr_mult
    adj_norm_mult2 = 1.0 / (1.0 + surr_mult2)
    surr_pwr = surr_mult2 * adj_norm_mult2
    pdc_f = torch.sqrt(1.0 - surr_pwr * torch.clamp(pd_s, max=1.0))
    pdc_s = torch.sqrt(surr_pwr)

    rets = []
    for arg in shelf_args:
        hf2 = arg * arg
        anm = 1.0 / (1.0 + hf2)
        spw = hf2 * anm
        front = torch.sqrt(1.0 - spw * torch.clamp(pd_s, max=1.0)) / pdc_f
        surr = torch.sqrt(spw) / torch.clamp(pdc_s, min=DBL_MIN)
        rets.append((front, surr))

    zero = torch.zeros_like(pdc_f)
    m = {
        "ll": pdc_f, "lr": zero, "rl": zero, "rr": pdc_f,
        "lsl": lsl * pdc_s, "lsr": lsr * pdc_s, "rsl": rsl * pdc_s, "rsr": rsr * pdc_s,
    }
    return m, rets


def calc_matrix_coefs_v4(ax_lr, ax_cs, dp_lr, dp_cs, surr_mult, surr_mult_rear, param,
                         shelf_args):
    """v4 matrix: full rear steering with adjustable surround separation."""
    lr, cs = ax_lr, ax_cs
    abs_lr = lr.abs()
    abs_cs = cs.abs()
    lsl = torch.ones_like(lr)
    rsr = torch.ones_like(lr)
    lsr = torch.zeros_like(lr)
    rsl = torch.zeros_like(lr)
    gl = 1.0 + torch.tan(abs_lr - M_PI_4)
    lsl = torch.where(lr > 0.0, lsl - gl * gl, lsl)
    lsr = torch.where(lr > 0.0, lsr - gl, lsr)
    rsl = torch.where(lr < 0.0, rsl - gl, rsl)
    rsr = torch.where(lr < 0.0, rsr - gl * gl, rsr)
    gc_2_pos = 0.5 + 0.5 * torch.tan(abs_cs - M_PI_4)
    cs_gc = torch.where(cs > -M_PI_4 / 2, abs_cs, M_PI_4 + cs)
    gc_2_neg = 0.5 + 0.5 * torch.tan(cs_gc - M_PI_4)
    pos, neg = cs > 0.0, cs < 0.0
    lsl = torch.where(pos, lsl - gc_2_pos, torch.where(neg, lsl - gc_2_neg, lsl))
    lsr = torch.where(pos, lsr - gc_2_pos, torch.where(neg, lsr + gc_2_neg, lsr))
    rsl = torch.where(pos, rsl - gc_2_pos, torch.where(neg, rsl + gc_2_neg, rsl))
    rsr = torch.where(pos, rsr - gc_2_pos, torch.where(neg, rsr - gc_2_neg, rsr))
    pu_sl = _pwr_sum(lsl, lsr)
    lsl = lsl / pu_sl
    lsr = lsr / pu_sl
    pu_sr = _pwr_sum(rsl, rsr)
    rsl = rsl / pu_sr
    rsr = rsr / pu_sr

    # front elements
    front_gc_2 = 0.5 + 0.5 * torch.tan(abs_cs - M_PI_4)
    front_cs = torch.where(cs > -M_PI_4 / 2, 4.0 * abs_cs, M_PI_2)
    front_lr_mult = torch.where(abs_lr <= M_PI_4 / 2, 1.0, 1.0 + torch.cos(4.0 * abs_lr)) * param
    ll_n = -front_gc_2
    rr_n = -front_gc_2
    lr_n = front_gc_2 + torch.zeros_like(front_gc_2)
    rl_n = front_gc_2 + torch.zeros_like(front_gc_2)
    ll_n = torch.where(lr > 0.0, ll_n - gl * gl * torch.sin(front_cs) * front_lr_mult, ll_n)
    lr_n = torch.where(lr > 0.0, lr_n + gl * (1.0 - torch.cos(front_cs)) * front_lr_mult, lr_n)
    rl_n = torch.where(lr < 0.0, rl_n + gl * (1.0 - torch.cos(front_cs)) * front_lr_mult, rl_n)
    rr_n = torch.where(lr < 0.0, rr_n - gl * gl * torch.sin(front_cs) * front_lr_mult, rr_n)
    cf_sm2 = torch.clamp(surr_mult_rear, max=1.0) ** 2
    cf = 1.0 - torch.sqrt((1.0 - cf_sm2) / (1.0 + cf_sm2))
    ll_n = 1.0 + ll_n * cf
    lr_n = lr_n * cf
    rl_n = rl_n * cf
    rr_n = 1.0 + rr_n * cf
    pu_fl = _pwr_sum(ll_n, lr_n)
    pu_fr = _pwr_sum(rl_n, rr_n)
    cs_nn = cs >= 0.0
    ll = torch.where(cs_nn, 1.0, ll_n / pu_fl)
    lrm = torch.where(cs_nn, 0.0, lr_n / pu_fl)
    rl = torch.where(cs_nn, 0.0, rl_n / pu_fr)
    rr = torch.where(cs_nn, 1.0, rr_n / pu_fr)

    l_real, l_imag, r_real, r_imag = _input_phasors(dp_lr, dp_cs)
    gd_fl2 = (ll * l_real + lrm * r_real) ** 2 + (ll * l_imag + lrm * r_imag) ** 2
    gd_fr2 = (rl * l_real + rr * r_real) ** 2 + (rl * l_imag + rr * r_imag) ** 2
    gd_sl2 = (lsl * l_real + lsr * r_real) ** 2 + (lsl * l_imag + lsr * r_imag) ** 2
    gd_sr2 = (rsl * l_real + rsr * r_real) ** 2 + (rsl * l_imag + rsr * r_imag) ** 2
    pd_f = gd_fl2 + gd_fr2
    pd_s = gd_sl2 + gd_sr2

    # weighted directional power
    abs_dp_lr = dp_lr.abs()
    abs_dp_cs = dp_cs.abs()
    lr2 = dp_lr * dp_lr
    cs2 = dp_cs * dp_cs
    wf_in = torch.where(lr2 + cs2 > DBL_MIN,
                        ((lr2 - cs2) / torch.clamp(lr2 + cs2, min=DBL_MIN)) ** 2, 0.0)
    case_a = (dp_cs < 0.0) & (abs_dp_cs < abs_dp_lr)
    case_b = (dp_cs < 0.0) & ~case_a
    pd_f_wf = torch.where(case_a, (pd_f - 1.0) * wf_in + 1.0, torch.where(case_b, 1.0, pd_f))
    pd_s_wf = torch.where(case_a, (pd_s - 1.0) * wf_in + 1.0, torch.where(case_b, 1.0, pd_s))
    pd_f_ws = torch.where(case_a, (pd_f - 1.0) * (1.0 - wf_in) + 1.0, torch.where(case_b, pd_f, 1.0))
    pd_s_ws = torch.where(case_a, (pd_s - 1.0) * (1.0 - wf_in) + 1.0, torch.where(case_b, pd_s, 1.0))

    surr_mult2 = surr_mult * surr_mult
    adj_norm_mult2 = 1.0 / (1.0 + surr_mult2)
    pdc_fi2 = (1.0 - surr_mult2 * adj_norm_mult2 * pd_s_wf) / pd_f_wf
    pdc_si2 = (1.0 - adj_norm_mult2 * pd_f_ws) / pd_s_ws
    pdc_all2 = 1.0 / (pd_f * pdc_fi2 + pd_s * pdc_si2)
    pdc_f = torch.sqrt(torch.clamp(pdc_fi2, min=0.0) * pdc_all2)
    pdc_s = torch.sqrt(torch.clamp(pdc_si2, min=0.0) * pdc_all2)

    rets = []
    for arg in shelf_args:
        hf2 = arg * arg
        anm = 1.0 / (1.0 + hf2)
        fi2 = (1.0 - hf2 * anm * pd_s_wf) / pd_f_wf
        si2 = (1.0 - anm * pd_f_ws) / pd_s_ws
        all2 = 1.0 / (pd_f * fi2 + pd_s * si2)
        front = torch.sqrt(torch.clamp(fi2, min=0.0) * all2) / pdc_f
        surr = torch.sqrt(torch.clamp(si2, min=0.0) * all2) / torch.clamp(pdc_s, min=DBL_MIN)
        rets.append((front, surr))

    m = {
        "ll": ll * pdc_f, "lr": lrm * pdc_f, "rl": rl * pdc_f, "rr": rr * pdc_f,
        "lsl": lsl * pdc_s, "lsr": lsr * pdc_s, "rsl": rsl * pdc_s, "rsr": rsr * pdc_s,
    }
    return m, rets


def phase_flip_pos_rs(ax_lr, ax_cs):
    x = ax_cs * (-2.0 / M_PI_4)
    x = x * x * 0.5 + 0.5
    return torch.where(ax_cs >= 0.0, 0.5, torch.clamp(x, max=1.0))


def phase_flip_ap1_c0(c0_const, c1_const, pos):
    return torch.exp(pos * (c1_const - c0_const) + c0_const) - 1.0


def surr_direct_pan(ax_lr, ax_cs):
    x = ax_lr.abs()
    y0 = ax_cs + (M_PI_4 / 2)
    y = torch.where(ax_cs > -M_PI_4 / 2, y0 * 2.0, y0)
    z = torch.clamp(torch.clamp(x - y, min=0.0) * 6.0, max=M_PI_2)
    amb = torch.where(ax_cs >= 0.0, 1.0, torch.cos(z))
    dire = torch.where(ax_cs >= 0.0, 0.0, torch.sin(z))
    return amb, dire


# --- what the kernels compute, and their plain versions -----------------------

# the event state's leaves in the kernel's order (csrc/m4_event.cu EvState):
# (name, kind) with kind b (bool), f (float64) or i (int64)
EV_LEAVES = (
    [(k, "b") for k in ("sample", "hold", "f1_l", "f1_r", "f1_use_ord", "f1_fuse", "f0_l",
                        "f0_r", "f0_use_ord", "f0_fuse", "f0_end")]
    + [(k, "f") for k in ("accom", "norm", "slow", "smooth", "avg", "drift", "drift_dpwr",
                          "drift_scale", "pwrcmp_factor", "ord_notch_scale", "ord_lp_m",
                          "svf_m", "dir_lr", "dir_cs", "ord_buf", "ord_lp_buf", "diff_buf",
                          "slope_buf", "ds_ord_buf", "max_buf", "last", "slope_last",
                          "diff_last", "max1", "max0", "ord_factor", "adj", "ds_diff")]
    + [(k, "i") for k in ("t", "t_sample", "t_hold", "buf_p", "ord_count", "diff_count",
                          "early_count", "ignore_count")]
)
N_INTERP = 16  # ll lr rl rr lsl lsr rsl rsr gss gsl gfs gfl pf0 pf1 amb dir


class M4Control:
    """What the control path of one matrix4 needs besides its state: the
    engine's parameters, the background smoother's and the per-tick
    epilogue's (K10) constants. Built once by the effect."""

    def __init__(self, ev_params, bg_g0, bg_c0, bg_c1, *, matrix_v4, matrix_param, dpwr_decouple,
                 surr_mult, contour_pwrcmp, shelf_mult, lowpass_mult, pf_c0, pf_c1, fade_frames):
        self.p = host_params(ev_params)
        self.bg = (float(bg_g0), float(bg_c0), float(bg_c1))
        self.matrix_v4 = bool(matrix_v4)
        self.matrix_param = float(matrix_param)
        self.dpwr_decouple = bool(dpwr_decouple)
        self.surr_mult = (float(surr_mult[0]), float(surr_mult[1]))
        self.contour_pwrcmp = float(contour_pwrcmp)
        self.shelf_mult = float(shelf_mult)
        self.lowpass_mult = float(lowpass_mult)
        self.pf_c0, self.pf_c1 = float(pf_c0), float(pf_c1)
        self.fade_frames = int(fade_frames)

    def c_structs(self):
        """(EvParams, K10Params) for csrc/m4_event.cu, cached."""
        if not hasattr(self, "_c"):
            from dsp_tpu_torch import kernels

            p = self.p
            ev = kernels.M4EvParams(
                *(p[k] for k in ("g_accom", "g_norm", "g_norm_fast", "g_slow", "g_smooth",
                                 "g_avg", "g_drift_slow", "g_drift_fast", "g_dpwr_slow",
                                 "g_dpwr_fast", "g_ds0", "g_ds1", "g_pwrcmp",
                                 "g_ord_notch_scale", "base_ord_ns")),
                (ctypes.c_double * 5)(*p["ord_lp_c"]),
                *(p[s][k] for s in ("svf1", "svf2") for k in ("a0", "alpha", "beta")),
                *(p[k] for k in ("clip_thresh", "pcf_sens", "ord_factor_c", "diff_lim",
                                 "rear_ev_mask", "accom_mask_fall", "norm_accom_factor")),
                EVENT_THRESH, *self.bg,
                *(p[k] for k in ("buf_len", "sample_frames", "max_hold_frames",
                                 "min_hold_frames")),
            )
            k10 = kernels.M4K10Params(
                self.surr_mult[0], self.surr_mult[1], self.contour_pwrcmp, self.shelf_mult,
                self.lowpass_mult, self.matrix_param, self.pf_c0, self.pf_c1,
                int(self.matrix_v4), int(self.dpwr_decouple), self.fade_frames,
                DOWNSAMPLE_FACTOR,
            )
            self._c = (ev, k10)
        return self._c


def _affine_scan_ref(a, b, m0):
    """States m[t] = a[t]·m[t-1] + b[t] over axis 0 from m0 (a Hillis-Steele
    doubling scan of the affine maps, log2(B) steps): [B, n]."""
    B = b.shape[0]
    a = a.expand_as(b)
    d = 1
    while d < B:
        b = torch.cat([b[:d], a[d:] * b[:-d] + b[d:]])
        a = torch.cat([a[:d], a[d:] * a[:-d]])
        d *= 2
    return a * m0 + b


def m4_env(ybp, env_m, g):
    """K11: the eight envelope EWMAs (|l|, |r|, |l+r|, |l-r| and the four
    squares) of the band-limited pair ybp [B, 2], m' = (1-g)·m + g·s, from
    env_m [8]; returns (env_m' [8], env_ds [Nc, 8]), the envelopes at the
    control ticks D-1, 2D-1, ... (D = 32). With a stream axis ybp [S, B, 2]
    and env_m [S, 8]: (env_m' [S, 8], env_ds [S, Nc, 8]). CPU tensors run
    m4_env_ref; CUDA tensors launch csrc/m4_env.cu."""
    if ybp.device.type == "cpu":
        return m4_env_ref(ybp, env_m, g)
    one = ybp.dim() == 2
    env_out, env_ds = _launch_env("m4_env", _streams(ybp, one)[:, :, None],
                                  _streams(env_m, one)[:, None], g)
    m4_env.launches += 1
    return _unstream((env_out[:, 0], env_ds[:, :, 0]), one)


m4_env.launches = 0


def m4_env_ref(ybp, env_m, g):
    """Plain PyTorch version of m4_env: the affine scan with the constant
    1 - g as a doubling scan; ybp [S, B, 2] a stream at a time."""
    if ybp.dim() == 3:
        return each_stream(lambda st, y: m4_env_ref(y, st, g), env_m, ybp)
    l, r = ybp[:, 0], ybp[:, 1]
    sum_, diff = l + r, l - r
    env_in = torch.stack([l.abs(), r.abs(), sum_.abs(), diff.abs(),
                          l * l, r * r, sum_ * sum_, diff * diff], dim=1)
    envs = _affine_scan_ref(torch.full((1, 8), 1.0 - g, dtype=env_in.dtype, device=env_in.device),
                            g * env_in, env_m)
    return envs[-1], envs[DOWNSAMPLE_FACTOR - 1 :: DOWNSAMPLE_FACTOR]


def m4_env_f32(ybp, ybp_lo, env_m, env_m_lo, g):
    """K11 in float32: m4_env on the (hi, lo) pair (ybp, ybp_lo) [B, 2] of
    the band-limit's output, from the carried pair (env_m, env_m_lo) [8],
    all float32, in float64 inside. Returns (env_m', env_m_lo', env_ds
    [Nc, 8] float64); with a stream axis each led by S. CPU tensors run
    m4_env_f32_ref; CUDA tensors launch csrc/m4_env.cu."""
    _check_dtypes("m4_env_f32", *[(t, torch.float32) for t in (ybp, ybp_lo, env_m, env_m_lo)])
    if ybp.device.type == "cpu":
        return m4_env_f32_ref(ybp, ybp_lo, env_m, env_m_lo, g)
    one = ybp.dim() == 2
    env_out, env_out_lo, env_ds = _launch_env(
        "m4_env_f32", _streams(ybp, one)[:, :, None], _streams(env_m, one)[:, None], g,
        lo=(_streams(ybp_lo, one)[:, :, None], _streams(env_m_lo, one)[:, None]))
    m4_env_f32.launches += 1
    return _unstream((env_out[:, 0], env_out_lo[:, 0], env_ds[:, :, 0]), one)


m4_env_f32.launches = 0


def m4_env_f32_ref(ybp, ybp_lo, env_m, env_m_lo, g):
    """Plain PyTorch version of m4_env_f32: m4_env_ref on hi + lo in
    float64, the carried envelopes split."""
    env, env_ds = m4_env_ref(ybp.double() + ybp_lo.double(), env_m.double() + env_m_lo.double(), g)
    return (*split_f64(env), env_ds)


def _streams(t, one):
    """t with a stream axis: a one-stream tensor (one) as one stream."""
    return t[None] if one else t


def _unstream(outs, one):
    """The outputs of a launch on stream-axis tensors, each of a one-stream
    call's shape where the call had no stream axis (one)."""
    return tuple(t[0] for t in outs) if one else outs


def _launch_env(name, bands, env_m, g, w=None, lo=None):
    """csrc/m4_env.cu on NS streams of G lanes: bands [NS, B, G, 2] and
    env_m [NS, G, 8] float64, or float32 with their lo parts lo =
    (bands_lo, env_m_lo); w [G, G] float64 or None, mixing each stream's
    lanes. Returns (env_m', env_ds [NS, Nc, G, 8] float64), with env_m_lo'
    between them under float32. Each stream takes the partition of G lanes
    (env_partition), never of NS·G: a one-stream launch's."""
    from dsp_tpu_torch import kernels

    dtype = torch.float64 if lo is None else torch.float32
    _check_cuda(name, bands, *[(t, dtype) for t in (bands, env_m, *(lo or ()))],
                *([(w, torch.float64)] if w is not None else []), align=4)
    NS, B, G = bands.shape[:3] if bands.dim() == 4 else (0, 0, 0)
    if (bands.dim() != 4 or bands.shape[3] != 2 or B % DOWNSAMPLE_FACTOR
            or tuple(env_m.shape) != (NS, G, 8) or (w is not None and tuple(w.shape) != (G, G))
            or (lo is not None and (lo[0].shape != bands.shape or lo[1].shape != env_m.shape))):
        raise ValueError(f"{name}: bands {tuple(bands.shape)}, env_m {tuple(env_m.shape)}, "
                         f"weights {None if w is None else tuple(w.shape)}")
    env_out = torch.empty_like(env_m)
    env_ds = torch.empty((NS, B // DOWNSAMPLE_FACTOR, G, 8), dtype=torch.float64,
                         device=bands.device)
    nseg, ntiles = env_partition(B, G)
    scratch = kernels.lookback_scratch(bands, ntiles * NS, 8 * G)
    if lo is None:
        kernels.launch_m4_env(bands, env_m, env_out, env_ds, float(g), nseg, scratch, w)
        return env_out, env_ds
    env_out_lo = torch.empty_like(env_m)
    kernels.launch_m4_env(bands, env_m, env_out, env_ds, float(g), nseg, scratch, w,
                          lo=(*lo, env_out_lo))
    return env_out, env_out_lo, env_ds


def env_partition(B, G):
    """How csrc/m4_env.cu cuts a block of B samples of a stream's G lanes
    (its launch takes nseg from here): (nseg, ntiles), tiles of nseg
    segments of DOWNSAMPLE_FACTOR samples, a thread block each with all G
    lanes, ntiles a stream. nseg is 8 for one lane and 4 for more, or 32
    for one lane at B >= 16384 and 8 for more above B = 8192: small blocks
    spread over the card, large ones look back over few tiles, and a tile's
    pairs fit in shared memory. It follows G alone: S streams of one lane
    (matrix4's batch) take the one-lane partition."""
    nseg = (32 if B >= 16384 else 8) if G == 1 else (8 if B > 8192 else 4)
    return nseg, -(-B // (nseg * DOWNSAMPLE_FACTOR))


# csrc/m4_event.cu's launch: four warps (the chain, the pre-phase and two of
# epilogue), a chunk of at most EVENT_MAX_CHUNK ticks (16 for matrix4_mb,
# whose table a tick is 13 times matrix4's), and its shared memory: the
# rings (10 buf_len doubles a band), two tables of EVENT_TABLE_SLOTS and two
# of EVENT_OUTPUTS doubles a tick and band, and for matrix4_mb two chunks of
# its 169 similarity terms a tick and the 26 diffs before a chunk. A block
# may hold SMEM_LIMIT bytes. Where the rings alone with a chunk of one tick
# would not fit (matrix4_mb from buf_len 217, 461.9 kHz: a chunk of one
# tick would need 237,328 bytes at 470.4 kHz, 381,888 at 768 kHz), they
# move to a scratch in device memory, which stays in the 50 MB L2, and the
# shared memory holds the tables alone.
EVENT_THREADS = 128
EVENT_MAX_CHUNK = 32
EVENT_MB_CHUNK = 16
EVENT_TABLE_SLOTS = 14
EVENT_OUTPUTS = 8
EVENT_RING_SLOTS = 10


def event_geometry(bands, buf_len, Nc):
    """(threads, chunk, shared memory bytes, ring doubles) of one m4_event
    (bands = 1) or m4mb_event (bands = 13) launch over Nc ticks with rings
    of buf_len: the largest chunk up to the engine's cap, and no longer than
    Nc, whose memory fits. Ring doubles is 0 when the rings sit in shared
    memory, else the size of each block's ring scratch in device memory
    (bands · 10 · buf_len), taken when the rings would not fit beside a
    chunk of one tick."""
    rings = bands * EVENT_RING_SLOTS * buf_len

    def smem(chunk, ring):
        mb = 2 * chunk * N_BANDS * N_BANDS + 2 * N_BANDS if bands == N_BANDS else 0
        return 8 * (ring + 2 * chunk * bands * (EVENT_TABLE_SLOTS + EVENT_OUTPUTS) + mb)

    ring = rings if smem(1, rings) <= SMEM_LIMIT else 0
    chunk = min(EVENT_MB_CHUNK if bands == N_BANDS else EVENT_MAX_CHUNK, Nc)
    while chunk > 1 and smem(chunk, ring) > SMEM_LIMIT:
        chunk -= 1
    if chunk < 1 or smem(chunk, ring) > SMEM_LIMIT:
        raise ValueError(f"event engine: {bands} band(s) need {smem(1, 0)} bytes of shared "
                         f"memory for a chunk of one tick, more than {SMEM_LIMIT}")
    return EVENT_THREADS, chunk, smem(chunk, ring), 0 if ring else rings


def _ring_scratch(geometry, lanes, device):
    """The device ring scratch of a launch (one a block of `lanes`), or
    None where the rings sit in shared memory."""
    n = geometry[3]
    return torch.empty(lanes * n, dtype=torch.float64, device=device) if n else None


def fade_ticks(fade_p, disable, fade_frames, Nc, like):
    """The fade multiplier at each control tick (fade_mult,
    matrix4_common.h:265-280; fade_p counts down per audio sample)."""
    D = DOWNSAMPLE_FACTOR
    tick_i = torch.arange(Nc, device=like.device) * D + (D - 1)
    fade_p_at = torch.clamp(int(fade_p) - tick_i, min=0)
    posf = fade_p_at.to(like.dtype) / fade_frames
    fade_lin = 1.0 - posf if not disable else posf
    fade_sm = (1.0 - torch.cos(fade_lin * np.pi)) * 0.5
    return torch.where(fade_p_at > 0, fade_sm, 0.0 if disable else 1.0)


def m4_event(ctl, ev, bg, env_ds, interp_y, fade_p, disable):
    """K9 + K10 for one block of S lanes.

    ev: the event state, every leaf [S, ...] (S = 1 for one stream of
    matrix4, S streams of a batch, a block each); bg: the background
    smoother [S, 2]; env_ds: [S, Nc, 8]; interp_y: [S, 4, 16]; fade_p,
    disable: host ints. Runs event_step and the smoother over the
    Nc ticks, then the per-tick epilogue (fade, contour gains, matrix
    coefficients, phase flip, direct pan) and the interpolator insert.
    Returns (ev', bg', ics [S, Nc, 3, 16], interp_y' [S, 4, 16],
    aux [S, Nc, 4]). CPU tensors run m4_event_ref; CUDA tensors launch
    csrc/m4_event.cu."""
    if env_ds.device.type == "cpu":
        return m4_event_ref(ctl, ev, bg, env_ds, interp_y, fade_p, disable)
    from dsp_tpu_torch import kernels

    leaves = [(ev[k], {"b": torch.bool, "f": torch.float64, "i": torch.int64}[kind])
              for k, kind in EV_LEAVES]
    _check_cuda("m4_event", env_ds, (env_ds, torch.float64), (bg, torch.float64),
                (interp_y, torch.float64), *leaves, align=1)
    S, Nc = env_ds.shape[0], env_ds.shape[1]
    _check_event_shapes("m4_event", ctl, ev, env_ds, (S, Nc, 8), bg, (S, 2), interp_y,
                        (S, 4, N_INTERP), (S,))
    out = {k: torch.empty_like(v) for k, v in ev.items()}
    bg_out = torch.empty_like(bg)
    dev = env_ds.device
    vt = torch.empty((S, Nc, N_INTERP), dtype=torch.float64, device=dev)
    ics = torch.empty((S, Nc, 3, N_INTERP), dtype=torch.float64, device=dev)
    iy_out = torch.empty_like(interp_y)
    aux = torch.empty((S, Nc, 4), dtype=torch.float64, device=dev)
    geo = event_geometry(1, ctl.p["buf_len"], Nc)
    kernels.launch_m4_event(ctl, ev, out, bg, bg_out, env_ds, vt, interp_y, ics, iy_out, aux,
                            int(fade_p), bool(disable), geo, _ring_scratch(geo, S, dev))
    m4_event.launches += 1
    return out, bg_out, ics, iy_out, aux


m4_event.launches = 0


def m4_event_f32(ctl, ev, ev_lo, bg, bg_lo, env_ds, interp_y, fade_p, disable):
    """K9 + K10 in float32: m4_event with every float leaf of ev as the
    float32 pair (ev[k], ev_lo[k]) and the background smoother as the pair
    (bg, bg_lo) [S, 2], env_ds [S, Nc, 8] float64 and interp_y [S, 4, 16]
    float32. The engine and the epilogue run in float64; the per-tick values
    are rounded to float32 before the insert. Returns (ev', ev_lo', bg',
    bg_lo', ics [S, Nc, 3, 16], interp_y', aux [S, Nc, 4]), the last three
    float32. CPU tensors run m4_event_f32_ref; CUDA tensors launch
    csrc/m4_event.cu."""
    _check_f32_state("m4_event_f32", ev, ev_lo, (bg, bg_lo, interp_y), env_ds)
    if env_ds.device.type == "cpu":
        return m4_event_f32_ref(ctl, ev, ev_lo, bg, bg_lo, env_ds, interp_y, fade_p, disable)
    from dsp_tpu_torch import kernels

    _check_cuda("m4_event_f32", env_ds, (env_ds, torch.float64), *_leaf_checks(ev, ev_lo),
                *[(t, torch.float32) for t in (bg, bg_lo, interp_y)], align=1)
    S, Nc = env_ds.shape[0], env_ds.shape[1]
    _check_event_shapes("m4_event_f32", ctl, ev, env_ds, (S, Nc, 8), bg, (S, 2), interp_y,
                        (S, 4, N_INTERP), (S,))
    out, out_lo = _empty_state(ev, ev_lo)
    bg_out, bg_out_lo = torch.empty_like(bg), torch.empty_like(bg_lo)
    dev, f32 = env_ds.device, torch.float32
    vt = torch.empty((S, Nc, N_INTERP), dtype=torch.float64, device=dev)
    ics = torch.empty((S, Nc, 3, N_INTERP), dtype=f32, device=dev)
    iy_out = torch.empty_like(interp_y)
    aux = torch.empty((S, Nc, 4), dtype=f32, device=dev)
    geo = event_geometry(1, ctl.p["buf_len"], Nc)
    kernels.launch_m4_event(ctl, ev, out, bg, bg_out, env_ds, vt, interp_y, ics, iy_out, aux,
                            int(fade_p), bool(disable), geo, _ring_scratch(geo, S, dev),
                            lo=(ev_lo, out_lo, bg_lo, bg_out_lo))
    m4_event_f32.launches += 1
    return out, out_lo, bg_out, bg_out_lo, ics, iy_out, aux


m4_event_f32.launches = 0


def m4_event_f32_ref(ctl, ev, ev_lo, bg, bg_lo, env_ds, interp_y, fade_p, disable):
    """Plain PyTorch version of m4_event_f32: m4_event_ref on the joined
    pairs in float64, the per-tick values rounded to float32, the state
    split."""
    st, bg2, ics, iy, aux = m4_event_ref(ctl, join_pairs(ev, ev_lo), bg.double() + bg_lo.double(),
                                         env_ds, interp_y, fade_p, disable, torch.float32)
    return (*split_pairs(st, ev_lo), *split_f64(bg2), ics, iy, aux)


def join_pairs(ev, ev_lo):
    """The state ev with each float leaf that has a lo part in ev_lo read
    as hi + lo in float64."""
    return {k: v.double() + ev_lo[k].double() if k in ev_lo else v for k, v in ev.items()}


def split_pairs(ev, ev_lo):
    """(ev with each leaf of ev_lo's names rounded to float32, those leaves'
    lo parts): the inverse of join_pairs."""
    hi, lo = dict(ev), {}
    for k in ev_lo:
        hi[k], lo[k] = split_f64(ev[k])
    return hi, lo


def _check_f32_state(name, ev, ev_lo, f32s, env_ds):
    """The float32 engines' dtypes, on every device: each float leaf of ev
    and its lo part and every tensor of f32s float32, env_ds float64."""
    _check_dtypes(name, (env_ds, torch.float64), *_leaf_checks(ev, ev_lo),
                  *[(t, torch.float32) for t in f32s])


def _leaf_checks(ev, ev_lo):
    """(tensor, dtype) for every leaf of the float32 event state: the bools,
    the float32 pairs, the int64 counters, in EV_LEAVES order."""
    kinds = {"b": torch.bool, "f": torch.float32, "i": torch.int64}
    checks = [(ev[k], kinds[kind]) for k, kind in EV_LEAVES]
    return checks + [(ev_lo[k], torch.float32) for k, kind in EV_LEAVES if kind == "f"]


def _empty_state(ev, ev_lo):
    return ({k: torch.empty_like(v) for k, v in ev.items()},
            {k: torch.empty_like(v) for k, v in ev_lo.items()})


def _check_event_shapes(name, ctl, ev, env_ds, env_shape, carry, carry_shape, interp_y, iy_shape,
                        lanes):
    """The shapes of an engine's inputs; lanes: the event state's leading
    axes ((S,) for matrix4, (13,) or (S, 13) for matrix4_mb)."""
    if (tuple(env_ds.shape) != env_shape or tuple(carry.shape) != carry_shape
            or tuple(interp_y.shape) != iy_shape
            or tuple(ev["ord_buf"].shape[:-1]) != (*lanes, ctl.p["buf_len"])):
        raise ValueError(f"{name}: env_ds {tuple(env_ds.shape)}, carry {tuple(carry.shape)}, "
                         f"interp_y {tuple(interp_y.shape)}, ord_buf {tuple(ev['ord_buf'].shape)}")


def m4_event_ref(ctl, ev, bg, env_ds, interp_y, fade_p, disable, out_dtype=torch.float64):
    """Plain PyTorch version of m4_event: event_step and smf_asym_run tick
    by tick, then the epilogue over all ticks at once, a lane at a time (a
    lane of S the bits of a one-lane call). With out_dtype float32 the
    per-tick values are rounded to it before the insert, and the
    coefficient sets, window and aux come out in it."""
    p = ctl.p
    S, Nc = env_ds.shape[0], env_ds.shape[1]
    if S > 1:
        lanes = [m4_event_ref(ctl, {k: v[s:s + 1] for k, v in ev.items()}, bg[s:s + 1],
                              env_ds[s:s + 1], interp_y[s:s + 1], fade_p, disable, out_dtype)
                 for s in range(S)]
        return _stack_tree([({k: v[0] for k, v in st.items()}, *(t[0] for t in rest))
                            for st, *rest in lanes])
    st = dict(ev)
    bg0, bg1 = bg[:, 0], bg[:, 1]
    keep = ("ax_lr", "ax_cs", "ax_ev_lr", "ax_ev_cs", "ax_dpwr_lr", "ax_dpwr_cs", "pwrcmp_factor")
    outs = {k: [] for k in keep}
    w1s = []
    g0, c0, c1 = ctl.bg
    for i in range(Nc):
        e8 = env_ds[:, i]
        env = {"l": e8[:, 0], "r": e8[:, 1], "sum": e8[:, 2], "diff": e8[:, 3]}
        pwr = {"l": e8[:, 4], "r": e8[:, 5], "sum": e8[:, 6], "diff": e8[:, 7]}
        st, out = event_step(p, st, env, pwr)
        w_step = smoothstep(out["ax_cs"] * (-2.0 / M_PI_4))
        (bg0, bg1), w1 = smf_asym_run((bg0, bg1), w_step + 1.0, g0, c0, c1)
        for k in keep:
            outs[k].append(out[k])
        w1s.append(w1)
    out = {k: torch.stack(v, 1) for k, v in outs.items()}  # [S, Nc]
    w1s = torch.stack(w1s, 1)
    vals, aux = m4_epilogue_ref(ctl, out, w1s, fade_p, disable)
    ics, iy_new = interp_insert_ref(interp_y.double(), vals.to(out_dtype).double())
    return (st, torch.stack([bg0, bg1], -1), ics.to(out_dtype), iy_new.to(out_dtype),
            aux.to(out_dtype))


def m4_epilogue_ref(ctl, out, w1s, fade_p, disable):
    """K10 over every tick: (vals [S, Nc, 16], aux [S, Nc, 4]) from the
    engine's outputs (each [S, Nc]) and the smoother's w1 [S, Nc]."""
    Nc = w1s.shape[1]
    fade = fade_ticks(fade_p, disable, ctl.fade_frames, Nc, w1s)[None]
    w = w1s - 1.0
    sm0, sm1 = ctl.surr_mult
    surr_mult = (w * sm1 + (1.0 - w) * sm0) * fade
    ct_pcf = ctl.contour_pwrcmp * out["pwrcmp_factor"]
    shelf_ct0 = w + (1.0 - w) * ctl.shelf_mult
    shelf_ct1 = (shelf_ct0 - 1.0) * ct_pcf + 1.0
    lp_ct0 = w + (1.0 - w) * ctl.lowpass_mult
    pw = torch.pow(torch.clamp(ct_pcf, min=DBL_MIN), 1.0 / ctl.shelf_mult)
    lp_ct1 = (lp_ct0 - 1.0) * pw + 1.0
    dp_lr = out["ax_dpwr_lr"] if ctl.dpwr_decouple else out["ax_lr"]
    dp_cs = out["ax_dpwr_cs"] if ctl.dpwr_decouple else out["ax_cs"]
    calc = calc_matrix_coefs_v4 if ctl.matrix_v4 else calc_matrix_coefs_v1
    m, rets = calc(out["ax_lr"], out["ax_cs"], dp_lr, dp_cs, surr_mult, sm1 * fade,
                   ctl.matrix_param, [surr_mult * shelf_ct1, surr_mult * shelf_ct1 * lp_ct1])
    g_surr_shelf = shelf_ct0 / shelf_ct1 * rets[0][1]
    g_surr_lp = lp_ct0 / lp_ct1 * rets[1][1] / torch.clamp(rets[0][1], min=DBL_MIN)
    g_front_shelf = rets[0][0]
    g_front_lp = rets[1][0] / rets[0][0]
    pf_pos = phase_flip_pos_rs(out["ax_lr"], out["ax_cs"])
    pf0 = phase_flip_ap1_c0(ctl.pf_c0, ctl.pf_c1, 1.0 - pf_pos)
    pf1 = phase_flip_ap1_c0(ctl.pf_c0, ctl.pf_c1, pf_pos)
    amb, dire = surr_direct_pan(out["ax_lr"], out["ax_cs"])
    vals = torch.stack([
        m["ll"], m["lr"], m["rl"], m["rr"], m["lsl"], m["lsr"], m["rsl"], m["rsr"],
        g_surr_shelf, g_surr_lp, g_front_shelf, g_front_lp, pf0, pf1, amb, dire,
    ], -1)
    aux = torch.stack([out["ax_lr"], out["ax_cs"], out["ax_ev_lr"], out["ax_ev_cs"]], -1)
    return vals, aux


def interp_insert_ref(interp_y, vals):
    """The parabolic 2x interpolator's insert (matrix4_common.h:358-367) at
    every tick: the window at tick t is [vals[t-3], .., vals[t]], the first
    rows from the carried interp_y [S, 4, 16]. Returns (ics [S, Nc, 3, 16],
    interp_y' [S, 4, 16])."""
    Nc = vals.shape[1]
    ext = torch.cat([interp_y[:, 1:], vals], dim=1)  # [S, Nc + 3, 16]
    iy0, iy1 = ext[:, :Nc], ext[:, 1 : Nc + 1]
    iy2, iy3 = ext[:, 2 : Nc + 2], ext[:, 3 : Nc + 3]
    ia = iy2 - iy0
    ics = torch.stack([0.5 * iy1 + 0.25 * (iy0 + iy2), 0.5 * ia, 0.25 * (iy3 - iy1 - ia)], dim=2)
    return ics, ext[:, -4:]


class M4Audio:
    """The audio path's constants (matrix4.py:597-671): the selected pair,
    the input and output channel counts, the lookahead line's length, the
    dynamic shelf's and lowpass's parameters (each on only when its mult is
    not 1), the phase flip and the direct path."""

    def __init__(self, c0, c1, n_in, length, shelf, shelf_on, lowpass, lowpass_on, phase_flip,
                 direct_path):
        self.c0, self.c1, self.n_in, self.len = int(c0), int(c1), int(n_in), int(length)
        self.n_out = n_in + (4 if direct_path else 2)
        self.shelf = {k: float(v) for k, v in shelf.items()}
        self.lowpass = {k: float(v) for k, v in lowpass.items()}
        self.shelf_on, self.lowpass_on = bool(shelf_on), bool(lowpass_on)
        self.phase_flip, self.direct_path = bool(phase_flip), bool(direct_path)

    def c_struct(self):
        """csrc/m4_audio.cu's AudioCfg, cached."""
        if not hasattr(self, "_c"):
            from dsp_tpu_torch import kernels

            sh, lp = self.shelf, self.lowpass
            self._c = kernels.M4AudioCfg(
                sh["sin_w0"], sh["cos_w0_p1"], sh["norm"], sh["c2"],
                lp["sin_w0"], lp["cos_w0_p1"], lp["norm"], lp["c2"],
                self.c0, self.c1, self.n_in, self.n_out, self.len, DOWNSAMPLE_FACTOR,
                int(self.shelf_on), int(self.lowpass_on), int(self.phase_flip),
                int(self.direct_path),
            )
        return self._c


def interp_vals_ref(interp_c, ics, B):
    """vals [B, 16] at audio rate from the coefficient sets: sample i uses
    set (i+1)//D of [interp_c | ics] at t = ((i+1) % D)/D."""
    D = DOWNSAMPLE_FACTOR
    all_ics = torch.cat([interp_c[None], ics], dim=0)
    i = torch.arange(B, device=ics.device)
    t = (((i + 1) % D).to(ics.dtype) / D)[:, None]
    coefs = all_ics[(i + 1) // D]  # [B, 3, 16]
    return (coefs[:, 2] * t + coefs[:, 1]) * t + coefs[:, 0]


def m4_audio(cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m):
    """K12 + K13: one block of matrix4's audio path. x [B, n_in]; buf
    [len, 2] the lookahead line; interp_c [3, 16] and ics [Nc, 3, 16] the
    coefficient sets; shelf_m, lp_m [4] and pf_m [2, 2] the filter states.
    Returns (y [B, n_out], shelf_m', lp_m', pf_m'); the carried line is the
    caller's (a splice). With a stream axis x [S, B, n_in] and every other
    tensor and output led by S. CPU tensors run m4_audio_ref; CUDA tensors
    launch csrc/m4_audio.cu."""
    if x.device.type == "cpu":
        return m4_audio_ref(cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m)
    from dsp_tpu_torch import kernels

    _check_cuda("m4_audio", x, *[(t, torch.float64) for t in (x, buf, interp_c, ics, shelf_m,
                                                               lp_m, pf_m)])
    _check_audio_shapes("m4_audio", cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m)
    y = x.new_empty((*x.shape[:-1], cfg.n_out))
    outs = (torch.empty_like(shelf_m), torch.empty_like(lp_m), torch.empty_like(pf_m))
    kernels.launch_m4_audio(cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m, y, *outs)
    m4_audio.launches += 1
    return (y, *outs)


m4_audio.launches = 0


def m4_audio_f32(cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m):
    """K12 + K13 in float32: m4_audio with x, the line, the coefficient sets
    and the states float32, computed in float64 registers; y and the states
    stored float32. CPU tensors run m4_audio_f32_ref; CUDA tensors launch
    csrc/m4_audio.cu."""
    ins = (x, buf, interp_c, ics, shelf_m, lp_m, pf_m)
    _check_dtypes("m4_audio_f32", *[(t, torch.float32) for t in ins])
    if x.device.type == "cpu":
        return m4_audio_f32_ref(cfg, *ins)
    from dsp_tpu_torch import kernels

    _check_cuda("m4_audio_f32", x, *[(t, torch.float32) for t in ins], align=4)
    _check_audio_shapes("m4_audio_f32", cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m)
    y = x.new_empty((*x.shape[:-1], cfg.n_out))
    outs = (torch.empty_like(shelf_m), torch.empty_like(lp_m), torch.empty_like(pf_m))
    kernels.launch_m4_audio(cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m, y, *outs)
    m4_audio_f32.launches += 1
    return (y, *outs)


m4_audio_f32.launches = 0


def m4_audio_f32_ref(cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m):
    """Plain PyTorch version of m4_audio_f32: m4_audio_ref on the upcast
    inputs, every output rounded to float32."""
    outs = m4_audio_ref(cfg, *(t.double() for t in (x, buf, interp_c, ics, shelf_m, lp_m, pf_m)))
    return tuple(t.float() for t in outs)


def _check_audio_shapes(name, cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m):
    lead = tuple(x.shape[:-2])
    B = x.shape[-2] if x.dim() in (2, 3) else 0
    Nc = B // DOWNSAMPLE_FACTOR
    if (x.dim() not in (2, 3) or x.shape[-1] != cfg.n_in or B % DOWNSAMPLE_FACTOR or B == 0
            or tuple(buf.shape) != (*lead, cfg.len, 2)
            or tuple(ics.shape) != (*lead, Nc, 3, N_INTERP)
            or tuple(interp_c.shape) != (*lead, 3, N_INTERP)
            or tuple(shelf_m.shape) != (*lead, 4) or tuple(lp_m.shape) != (*lead, 4)
            or tuple(pf_m.shape) != (*lead, 2, 2)):
        raise ValueError(f"{name}: x {tuple(x.shape)}, buf {tuple(buf.shape)}, "
                         f"ics {tuple(ics.shape)}")


def _dyn_shelf_ref(pr, m0, sig, g):
    """dyn_shelf_run (matrix4.c:89-98) over a block: r = c0s + m,
    m' = c1s - c2·r, as the affine scan m' = -c2·m + (c1s - c2·c0s)."""
    sn = sig * pr["norm"]
    gcp1 = g * pr["cos_w0_p1"]
    c0s = (pr["sin_w0"] + gcp1) * sn
    c1s = (pr["sin_w0"] - gcp1) * sn
    ms = _affine_scan_ref(torch.full((1, sig.shape[1]), -pr["c2"], dtype=sig.dtype,
                                     device=sig.device), c1s - pr["c2"] * c0s, m0)
    m_prev = torch.cat([m0[None], ms[:-1]])
    return ms[-1], c0s + m_prev


def _ap1_ref(st, sig, c0s):
    """ap1 with a time-varying c0 (allpass.h:46-56) on columns: with
    state (i0, o0), r = i0 + c0·(x - o0), i0' = x, o0' = r; the o0 chain
    is the affine scan o0' = -c0·o0 + (i0 + c0·x). st [n, 2]; sig, c0s
    [B, n]. Returns (st' [n, 2], r [B, n])."""
    i0 = torch.cat([st[None, :, 0], sig[:-1]])
    o0 = _affine_scan_ref(-c0s, i0 + c0s * sig, st[:, 1])
    o0_prev = torch.cat([st[None, :, 1], o0[:-1]])
    r = i0 + c0s * (sig - o0_prev)
    return torch.stack([sig[-1], r[-1]], -1), r


def m4_audio_ref(cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m):
    """Plain PyTorch version of m4_audio; x [S, B, n_in] a stream at a
    time."""
    if x.dim() == 3:
        return _stack_tree([m4_audio_ref(cfg, *(t[s] for t in (x, buf, interp_c, ics, shelf_m,
                                                                lp_m, pf_m)))
                            for s in range(x.shape[0])])
    B = x.shape[0]
    vals = interp_vals_ref(interp_c, ics, B)
    pair = x[:, [cfg.c0, cfg.c1]]
    delayed = torch.cat([buf, pair])[:B]
    s0, s1 = delayed[:, 0:1], delayed[:, 1:2]
    sig = torch.cat([s0 * vals[:, 0:1] + s1 * vals[:, 1:2], s0 * vals[:, 2:3] + s1 * vals[:, 3:4],
                     s0 * vals[:, 4:5] + s1 * vals[:, 5:6] + 1e-15,
                     s0 * vals[:, 6:7] + s1 * vals[:, 7:8] + 1e-15], dim=1)  # l r ls rs
    if cfg.shelf_on:
        gg = vals[:, [10, 10, 8, 8]]
        shelf_m, sig = _dyn_shelf_ref(cfg.shelf, shelf_m, sig, gg)
    if cfg.lowpass_on:
        gg = vals[:, [11, 11, 9, 9]]
        lp_m, sig = _dyn_shelf_ref(cfg.lowpass, lp_m, sig, gg)
    surr = sig[:, 2:]
    surr_pf = surr
    if cfg.phase_flip:
        pf_m, surr_pf = _ap1_ref(pf_m, surr, vals[:, 12:14])
    cols = [sig[:, 0] if k == cfg.c0 else sig[:, 1] if k == cfg.c1 else x[:, k]
            for k in range(cfg.n_in)]
    if cfg.direct_path:
        amb, dire = vals[:, 14], vals[:, 15]
        cols += [(surr_pf[:, 0] - 1e-15) * amb, (surr_pf[:, 1] - 1e-15) * amb,
                 (surr[:, 0] - 1e-15) * dire, -(surr[:, 1] - 1e-15) * dire]
    else:
        cols += [surr_pf[:, 0] - 1e-15, surr_pf[:, 1] - 1e-15]
    return torch.stack(cols, dim=1), shelf_m, lp_m, pf_m


# --- matrix4_mb: 13 coupled band engines (effects/matrix4_mb.py) -------------

N_BANDS = 13
N_SIG_MB = 12  # ll lr rl rr lsl lsr rsl rsr pf0 pf1 amb dir
# make_event_params' entries that differ by band (the rest are equal), and
# its integers (they index and bound loops: one value for all bands)
LANE_PARAMS = ("base_ord_ns", "clip_thresh", "pcf_sens")
INT_PARAMS = ("buf_len", "sample_frames", "max_hold_frames", "min_hold_frames")
_SPLIT = 134217729.0  # 2**27 + 1, Veltkamp's splitter for float64


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    p = a * b
    ta, tb = a * _SPLIT, b * _SPLIT
    ah, bh = ta - (ta - a), tb - (tb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma_ref(a, b, c):
    """a·b + c rounded once, as a fused multiply-add rounds it, from
    float64 tensor operations that each round: the product as an exact
    pair, the three-term sum by Boldo and Melquiond's rounding-to-odd
    (a sum of three correctly rounded). dsp_tpu's XLA:CPU contracts some
    products into their sums; the plain versions do the same where the
    result decides an event threshold."""
    a, b, c = torch.broadcast_tensors(*(torch.as_tensor(v, dtype=torch.float64,
                                                        device=_device_of(a, b, c))
                                        for v in (a, b, c)))
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, math.inf, -math.inf).to(v.dtype)
    v = torch.where((e != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def _device_of(*vs):
    return next((v.device for v in vs if isinstance(v, torch.Tensor)), torch.device("cpu"))


class M4MbControl:
    """What the control path of one matrix4_mb needs besides its state: the
    13 bands' engine parameters (equal but for LANE_PARAMS), the event
    threshold's bounds and EWMA gain, the band contour and the per-tick
    epilogue's constants. Built once by the effect."""

    def __init__(self, ev_params, ev_thresh_max, ev_thresh_min, g_ev_thresh, contour, *,
                 matrix_v4, matrix_param, dpwr_decouple, surr_mult, contour_pwrcmp, pf_c0,
                 pf_c1, fade_frames):
        band0 = {k: (v if k in INT_PARAMS
                     else {kk: np.asarray(vv)[0] for kk, vv in v.items()} if isinstance(v, dict)
                     else np.asarray(v)[0])
                 for k, v in ev_params.items()}
        self.p = host_params(band0)
        self.lanes = {k: np.asarray(ev_params[k], dtype=np.float64) for k in LANE_PARAMS}
        for k, v in ev_params.items():
            if k not in LANE_PARAMS and k != "base_thresh_scale" and not isinstance(v, (int, dict)):
                if not np.all(np.asarray(v) == np.asarray(v)[:1]):
                    raise ValueError(f"matrix4_mb: event parameter {k} differs by band")
        self.etmax = np.asarray(ev_thresh_max, dtype=np.float64)
        self.etmin = np.asarray(ev_thresh_min, dtype=np.float64)
        self.g_evt = float(g_ev_thresh)
        self.contour = np.asarray(contour, dtype=np.float64)
        self.matrix_v4 = bool(matrix_v4)
        self.matrix_param = float(matrix_param)
        self.dpwr_decouple = bool(dpwr_decouple)
        self.surr_mult = (float(surr_mult[0]), float(surr_mult[1]))
        self.contour_pwrcmp = float(contour_pwrcmp)
        self.pf_c0, self.pf_c1 = float(pf_c0), float(pf_c1)
        self.fade_frames = int(fade_frames)
        self._tensors = {}

    def tensors(self, device):
        """(the engine parameters with LANE_PARAMS as [13] tensors, etmax,
        etmin, contour) on `device`, cached."""
        key = torch.device(device)
        if key not in self._tensors:
            def t(a):
                return torch.as_tensor(a, dtype=torch.float64, device=key)

            p = dict(self.p, **{k: t(v) for k, v in self.lanes.items()})
            self._tensors[key] = (p, t(self.etmax), t(self.etmin), t(self.contour))
        return self._tensors[key]

    def c_structs(self):
        """(EvParams of band 0, MbParams) for csrc/m4_event.cu, cached."""
        if not hasattr(self, "_c"):
            from dsp_tpu_torch import kernels

            p = self.p
            ev = kernels.M4EvParams(
                *(p[k] for k in ("g_accom", "g_norm", "g_norm_fast", "g_slow", "g_smooth",
                                 "g_avg", "g_drift_slow", "g_drift_fast", "g_dpwr_slow",
                                 "g_dpwr_fast", "g_ds0", "g_ds1", "g_pwrcmp",
                                 "g_ord_notch_scale", "base_ord_ns")),
                (ctypes.c_double * 5)(*p["ord_lp_c"]),
                *(p[s][k] for s in ("svf1", "svf2") for k in ("a0", "alpha", "beta")),
                *(p[k] for k in ("clip_thresh", "pcf_sens", "ord_factor_c", "diff_lim",
                                 "rear_ev_mask", "accom_mask_fall", "norm_accom_factor")),
                EVENT_THRESH, 0.0, 0.0, 0.0,
                *(p[k] for k in ("buf_len", "sample_frames", "max_hold_frames",
                                 "min_hold_frames")),
            )
            arr = ctypes.c_double * N_BANDS
            mb = kernels.M4MbParams(
                arr(*self.etmax), arr(*self.etmin), arr(*self.contour),
                *(arr(*self.lanes[k]) for k in LANE_PARAMS),
                self.g_evt, self.surr_mult[0], self.surr_mult[1], self.contour_pwrcmp,
                self.matrix_param, self.pf_c0, self.pf_c1,
                int(self.matrix_v4), int(self.dpwr_decouple), self.fade_frames, DOWNSAMPLE_FACTOR,
            )
            self._c = (ev, mb)
        return self._c


def mb_threshold_ref(ctl, ev, evt):
    """The cross-band event threshold modulation of one tick
    (matrix4_mb.c:379-418, dsp_tpu/effects/matrix4_mb.py:467-480): every
    band's threshold [13] moves toward a target set by the bands that are
    rising past their minimum threshold (`cand`) and by how alike their
    previous tick's steering is (`sim`). Reads the engines' state before
    the tick. As dsp_tpu's XLA:CPU computes it: `fact` summed left to
    right; `1 - max(d)·16/π`, the target's last product and sum, and the
    EWMA each one fused multiply-add (measured against dsp_tpu's own scan,
    tests/test_torch_matrix4_mb.py)."""
    _, etmax, etmin, _ = ctl.tensors(evt.device)
    sl, la, d = ev["slope_last"], ev["last"], ev["diff_last"]
    cand = ((sl[:, 0] > 0.0) & (la[:, 0] > etmin)) | ((sl[:, 1] > 0.0) & (la[:, 1] > etmin))
    d_lr = (d[:, None, 0] - d[None, :, 0]).abs()
    d_cs = (d[:, None, 1] - d[None, :, 1]).abs()
    sim = smoothstep(fma_ref(-torch.maximum(d_lr, d_cs), float(16.0 / np.pi), 1.0))
    terms = sim * cand[None, :].to(sim.dtype)
    fact = terms[:, 0]
    for j in range(1, N_BANDS):
        fact = fact + terms[:, j]
    fact = torch.where(cand, fact - 1.0, 0.0)
    target = fma_ref(-((etmax - etmin) * fact), 1.0 / (N_BANDS - 1), etmax)
    up = fma_ref(ctl.g_evt, target - evt, evt)
    return torch.where(target >= evt, up, target)


def m4mb_event(ctl, ev, evt, env_ds, interp_y, fade_p, disable):
    """K9 + K10 of matrix4_mb for one block: the 13 band engines, coupled
    through their thresholds every tick, then the per-tick epilogue and the
    interpolator insert. ev: the event state, every leaf [13, ...]; evt:
    the thresholds [13]; env_ds: [Nc, 13, 8]; interp_y: [4, 13, 12];
    fade_p, disable: host ints. Returns (ev', evt', ics [Nc, 3, 13, 12],
    interp_y', aux [Nc, 13, 2]), dsp_tpu's layouts. With a stream axis
    (evt [S, 13]) every tensor and output is led by S, a block a stream.
    CPU tensors run m4mb_event_ref; CUDA tensors launch csrc/m4_event.cu."""
    if env_ds.device.type == "cpu":
        return m4mb_event_ref(ctl, ev, evt, env_ds, interp_y, fade_p, disable)
    from dsp_tpu_torch import kernels

    leaves = [(ev[k], {"b": torch.bool, "f": torch.float64, "i": torch.int64}[kind])
              for k, kind in EV_LEAVES]
    _check_cuda("m4mb_event", env_ds, (env_ds, torch.float64), (evt, torch.float64),
                (interp_y, torch.float64), *leaves, align=1)
    lead, Nc = tuple(evt.shape[:-1]), env_ds.shape[-3]
    _check_event_shapes("m4mb_event", ctl, ev, env_ds, (*lead, Nc, N_BANDS, 8), evt,
                        (*lead, N_BANDS), interp_y, (*lead, 4, N_BANDS, N_SIG_MB),
                        (*lead, N_BANDS))
    out = {k: torch.empty_like(v) for k, v in ev.items()}
    evt_out = torch.empty_like(evt)
    dev = env_ds.device
    vt = torch.empty((*lead, Nc, N_BANDS, N_SIG_MB), dtype=torch.float64, device=dev)
    ics = torch.empty((*lead, Nc, 3, N_BANDS, N_SIG_MB), dtype=torch.float64, device=dev)
    iy_out = torch.empty_like(interp_y)
    aux = torch.empty((*lead, Nc, N_BANDS, 2), dtype=torch.float64, device=dev)
    geo = event_geometry(N_BANDS, ctl.p["buf_len"], Nc)
    S = lead[0] if lead else 1
    kernels.launch_m4mb_event(ctl, ev, out, evt, evt_out, env_ds, vt, interp_y, ics, iy_out, aux,
                              int(fade_p), bool(disable), geo, _ring_scratch(geo, S, dev), S)
    m4mb_event.launches += 1
    return out, evt_out, ics, iy_out, aux


m4mb_event.launches = 0


def m4mb_event_f32(ctl, ev, ev_lo, evt, evt_lo, env_ds, interp_y, fade_p, disable):
    """K9 + K10 of matrix4_mb in float32: m4mb_event with every float leaf
    of ev as the float32 pair (ev[k], ev_lo[k]) and the thresholds as the
    pair (evt, evt_lo) [13], env_ds [Nc, 13, 8] float64 and interp_y
    [4, 13, 12] float32. The engines, the threshold modulation and the
    epilogue run in float64; the per-tick values are rounded to float32
    before the insert. Returns (ev', ev_lo', evt', evt_lo', ics
    [Nc, 3, 13, 12], interp_y', aux [Nc, 13, 2]), the last three float32;
    with a stream axis (evt [S, 13]) every tensor led by S. CPU tensors run
    m4mb_event_f32_ref; CUDA tensors launch csrc/m4_event.cu."""
    _check_f32_state("m4mb_event_f32", ev, ev_lo, (evt, evt_lo, interp_y), env_ds)
    if env_ds.device.type == "cpu":
        return m4mb_event_f32_ref(ctl, ev, ev_lo, evt, evt_lo, env_ds, interp_y, fade_p, disable)
    from dsp_tpu_torch import kernels

    _check_cuda("m4mb_event_f32", env_ds, (env_ds, torch.float64), *_leaf_checks(ev, ev_lo),
                *[(t, torch.float32) for t in (evt, evt_lo, interp_y)], align=1)
    lead, Nc = tuple(evt.shape[:-1]), env_ds.shape[-3]
    _check_event_shapes("m4mb_event_f32", ctl, ev, env_ds, (*lead, Nc, N_BANDS, 8), evt,
                        (*lead, N_BANDS), interp_y, (*lead, 4, N_BANDS, N_SIG_MB),
                        (*lead, N_BANDS))
    out, out_lo = _empty_state(ev, ev_lo)
    evt_out, evt_out_lo = torch.empty_like(evt), torch.empty_like(evt_lo)
    dev, f32 = env_ds.device, torch.float32
    vt = torch.empty((*lead, Nc, N_BANDS, N_SIG_MB), dtype=torch.float64, device=dev)
    ics = torch.empty((*lead, Nc, 3, N_BANDS, N_SIG_MB), dtype=f32, device=dev)
    iy_out = torch.empty_like(interp_y)
    aux = torch.empty((*lead, Nc, N_BANDS, 2), dtype=f32, device=dev)
    geo = event_geometry(N_BANDS, ctl.p["buf_len"], Nc)
    S = lead[0] if lead else 1
    kernels.launch_m4mb_event(ctl, ev, out, evt, evt_out, env_ds, vt, interp_y, ics, iy_out, aux,
                              int(fade_p), bool(disable), geo, _ring_scratch(geo, S, dev), S,
                              lo=(ev_lo, out_lo, evt_lo, evt_out_lo))
    m4mb_event_f32.launches += 1
    return out, out_lo, evt_out, evt_out_lo, ics, iy_out, aux


m4mb_event_f32.launches = 0


def m4mb_event_f32_ref(ctl, ev, ev_lo, evt, evt_lo, env_ds, interp_y, fade_p, disable):
    """Plain PyTorch version of m4mb_event_f32: m4mb_event_ref on the joined
    pairs in float64, the per-tick values rounded to float32, the state and
    thresholds split."""
    st, evt2, ics, iy, aux = m4mb_event_ref(ctl, join_pairs(ev, ev_lo),
                                            evt.double() + evt_lo.double(), env_ds, interp_y,
                                            fade_p, disable, torch.float32)
    return (*split_pairs(st, ev_lo), *split_f64(evt2), ics, iy, aux)


def m4mb_event_ref(ctl, ev, evt, env_ds, interp_y, fade_p, disable, out_dtype=torch.float64):
    """Plain PyTorch version of m4mb_event: a loop over the ticks of the
    threshold modulation and event_step over the 13 band lanes, then the
    epilogue over every tick and band at once. out_dtype as m4_event_ref's.
    With a stream axis (evt [S, 13]) a stream at a time."""
    if evt.dim() == 2:
        return _stack_tree([
            m4mb_event_ref(ctl, {k: v[s] for k, v in ev.items()}, evt[s], env_ds[s], interp_y[s],
                           fade_p, disable, out_dtype) for s in range(evt.shape[0])])
    p = ctl.tensors(env_ds.device)[0]
    Nc = env_ds.shape[0]
    st = dict(ev)
    keep = ("ax_lr", "ax_cs", "ax_dpwr_lr", "ax_dpwr_cs", "pwrcmp_factor")
    outs = {k: [] for k in keep}
    for i in range(Nc):
        evt = mb_threshold_ref(ctl, st, evt)
        e8 = env_ds[i]
        env = {"l": e8[:, 0], "r": e8[:, 1], "sum": e8[:, 2], "diff": e8[:, 3]}
        pwr = {"l": e8[:, 4], "r": e8[:, 5], "sum": e8[:, 6], "diff": e8[:, 7]}
        st, out = event_step(p, st, env, pwr, evt * (1.0 / EVENT_THRESH))
        for k in keep:
            outs[k].append(out[k])
    out = {k: torch.stack(v) for k, v in outs.items()}  # [Nc, 13]
    vals, aux = m4mb_epilogue_ref(ctl, out, fade_ticks(fade_p, disable, ctl.fade_frames, Nc, evt))
    ext = torch.cat([interp_y[1:].double(), vals.to(out_dtype).double()])  # [Nc + 3, 13, 12]
    iy0, iy1, iy2, iy3 = ext[:Nc], ext[1:Nc + 1], ext[2:Nc + 2], ext[3:]
    ia = iy2 - iy0
    ics = torch.stack([0.5 * iy1 + 0.25 * (iy0 + iy2), 0.5 * ia, 0.25 * (iy3 - iy1 - ia)], dim=1)
    return st, evt, ics.to(out_dtype), ext[-4:].to(out_dtype), aux.to(out_dtype)


def m4mb_epilogue_ref(ctl, out, fade):
    """K10 of matrix4_mb over every tick and band (matrix4_mb.py:505-527):
    (vals [Nc, 13, 12], aux [Nc, 13, 2]) from the engines' outputs (each
    [Nc, 13]) and the fade at the ticks [Nc]. No background smoother: the
    weight w comes from ax_cs itself; each band has its static contour."""
    contour = ctl.tensors(fade.device)[3]
    fade = fade[:, None]
    w = smoothstep(out["ax_cs"] * (-2.0 / M_PI_4))
    sm0, sm1 = ctl.surr_mult
    surr_mult = (w * sm1 + (1.0 - w) * sm0) * fade
    ct_pcf = ctl.contour_pwrcmp * out["pwrcmp_factor"]
    ct0 = w + (1.0 - w) * contour[None, :]
    ct1 = (ct0 - 1.0) * ct_pcf + 1.0
    ct2 = ct0 / ct1
    dp_lr = out["ax_dpwr_lr"] if ctl.dpwr_decouple else out["ax_lr"]
    dp_cs = out["ax_dpwr_cs"] if ctl.dpwr_decouple else out["ax_cs"]
    calc = calc_matrix_coefs_v4 if ctl.matrix_v4 else calc_matrix_coefs_v1
    m, _ = calc(out["ax_lr"], out["ax_cs"], dp_lr, dp_cs, surr_mult * ct1, sm1 * fade,
                ctl.matrix_param, [])
    pf_pos = phase_flip_pos_rs(out["ax_lr"], out["ax_cs"])
    pf0 = phase_flip_ap1_c0(ctl.pf_c0, ctl.pf_c1, 1.0 - pf_pos)
    pf1 = phase_flip_ap1_c0(ctl.pf_c0, ctl.pf_c1, pf_pos)
    amb, dire = surr_direct_pan(out["ax_lr"], out["ax_cs"])
    vals = torch.stack([m["ll"], m["lr"], m["rl"], m["rr"], m["lsl"] * ct2, m["lsr"] * ct2,
                        m["rsl"] * ct2, m["rsr"] * ct2, pf0, pf1, amb, dire], -1)
    return vals, torch.stack([out["ax_lr"], out["ax_cs"]], -1)


def band_mix_weights(freq_mask):
    """The lower-triangular frequency-mask mix (matrix4_mb.c:391-392) as a
    [13, 13] numpy array, or None when freq_mask is 0 (no mix)."""
    if freq_mask == 0.0:
        return None
    k = np.arange(N_BANDS)
    return np.tril(freq_mask ** (k[:, None] - k[None, :])) * np.tril(np.ones((N_BANDS, N_BANDS)))


def m4mb_env(bands, env_m, g, w=None):
    """K11 over the 13 band lanes: the analysis signals (bands [B, 13, 2],
    mixed by the frequency mask's weights w [13, 13] when given, a tensor
    on the bands' device), their eight envelope EWMAs from env_m [13, 8],
    and the envelopes at the ticks. Returns (env_m' [13, 8], env_ds
    [Nc, 13, 8]); with a stream axis bands [S, B, 13, 2] and env_m
    [S, 13, 8], each output led by S. CPU tensors run m4mb_env_ref; CUDA
    tensors launch csrc/m4_env.cu."""
    if bands.device.type == "cpu":
        return m4mb_env_ref(bands, env_m, g, w)
    one = bands.dim() == 3
    out = _launch_env("m4mb_env", _streams(bands, one), _streams(env_m, one), g, w)
    m4mb_env.launches += 1
    return _unstream(out, one)


m4mb_env.launches = 0


def m4mb_env_f32(bands, bands_lo, env_m, env_m_lo, g, w=None):
    """K11 over the 13 band lanes in float32: m4mb_env on the (hi, lo) pair
    (bands, bands_lo) [B, 13, 2] of the bank's output, from the carried
    pair (env_m, env_m_lo) [13, 8], the mix and the sums in float64.
    Returns (env_m', env_m_lo', env_ds [Nc, 13, 8] float64); with a stream
    axis each led by S. CPU tensors run m4mb_env_f32_ref; CUDA tensors
    launch csrc/m4_env.cu."""
    _check_dtypes("m4mb_env_f32", *[(t, torch.float32) for t in (bands, bands_lo, env_m, env_m_lo)])
    if bands.device.type == "cpu":
        return m4mb_env_f32_ref(bands, bands_lo, env_m, env_m_lo, g, w)
    one = bands.dim() == 3
    out = _launch_env("m4mb_env_f32", _streams(bands, one), _streams(env_m, one), g, w,
                      lo=(_streams(bands_lo, one), _streams(env_m_lo, one)))
    m4mb_env_f32.launches += 1
    return _unstream(out, one)


m4mb_env_f32.launches = 0


def m4mb_env_f32_ref(bands, bands_lo, env_m, env_m_lo, g, w=None):
    """Plain PyTorch version of m4mb_env_f32: m4mb_env_ref on hi + lo in
    float64, the carried envelopes split."""
    env, env_ds = m4mb_env_ref(bands.double() + bands_lo.double(),
                               env_m.double() + env_m_lo.double(), g, w)
    return (*split_f64(env), env_ds)


def band_mix_ref(bands, w):
    """ana[:, k] = sum over j <= k of w[k, j]·bands[:, j], summed from j = 0
    up, each product rounded (the kernel's order)."""
    cols = []
    for k in range(bands.shape[1]):
        acc = bands[:, 0] * w[k, 0]
        for j in range(1, k + 1):
            acc = acc + bands[:, j] * w[k, j]
        cols.append(acc)
    return torch.stack(cols, 1)


def mb_envelopes_ref(bands, env_m, g, w=None):
    """The eight envelope EWMAs of every band at every sample, [B, 13, 8]:
    what m4mb_env computes before it keeps the ticks."""
    ana = bands if w is None else band_mix_ref(bands, w)
    l, r = ana[:, :, 0], ana[:, :, 1]
    sum_, diff = l + r, l - r
    env_in = torch.stack([l.abs(), r.abs(), sum_.abs(), diff.abs(),
                          l * l, r * r, sum_ * sum_, diff * diff], dim=2)  # [B, S, 8]
    a = torch.full((1,) + tuple(env_m.shape), 1.0 - g, dtype=env_in.dtype, device=env_in.device)
    return _affine_scan_ref(a, g * env_in, env_m)


def m4mb_env_ref(bands, env_m, g, w=None):
    """Plain PyTorch version of m4mb_env; bands [S, B, 13, 2] a stream at a
    time."""
    if bands.dim() == 4:
        return each_stream(lambda st, b: m4mb_env_ref(b, st, g, w), env_m, bands)
    envs = mb_envelopes_ref(bands, env_m, g, w)
    return envs[-1], envs[DOWNSAMPLE_FACTOR - 1 :: DOWNSAMPLE_FACTOR]


class M4MbAudio:
    """matrix4_mb's audio path constants: the lookahead line's length, the
    phase flip and the direct path."""

    def __init__(self, fb_buf_len, phase_flip, direct_path):
        self.len = int(fb_buf_len)
        self.phase_flip, self.direct_path = bool(phase_flip), bool(direct_path)
        self.n_sig = 6 if direct_path else 4


def m4mb_audio(cfg, bands, fb_buf, interp_c, ics, pf_m):
    """K12 + K13 of matrix4_mb for one block: the interpolated matrix values
    of every band, the lookahead-delayed bands (fb_buf [len, 13, 2], then
    this block's bands [B, 13, 2]) through each band's 2 -> 4 matrix, the
    band sums, the phase-flip allpasses over the 26 surround lanes (state
    pf_m [13, 2, 2]) and the direct path. Returns (sig [B, 4 or 6]: l, r,
    ls, rs (and the direct pair) with the 1e-15/324 offsets, ready for the
    inverse fshape; pf_m'). With a stream axis bands [S, B, 13, 2] and every
    other tensor and output led by S. CPU tensors run m4mb_audio_ref; CUDA
    tensors launch csrc/m4mb_audio.cu."""
    if bands.device.type == "cpu":
        return m4mb_audio_ref(cfg, bands, fb_buf, interp_c, ics, pf_m)
    _check_cuda("m4mb_audio", bands, *[(t, torch.float64) for t in (bands, fb_buf, interp_c, ics,
                                                                      pf_m)])
    _check_mb_audio_shapes("m4mb_audio", cfg, bands, fb_buf, interp_c, ics, pf_m)
    out = _launch_mb_audio(cfg, bands, fb_buf, interp_c, ics, pf_m)
    m4mb_audio.launches += 1
    return out


m4mb_audio.launches = 0


def m4mb_audio_f32(cfg, bands, fb_buf, interp_c, ics, pf_m):
    """K12 + K13 of matrix4_mb in float32: m4mb_audio with the bands (the
    hi half of the bank's (hi, lo) output), the line, the coefficient sets
    and the allpass states float32, computed in float64 registers; the 4 or
    6 signals and the states stored float32. CPU tensors run
    m4mb_audio_f32_ref; CUDA tensors launch csrc/m4mb_audio.cu."""
    ins = (bands, fb_buf, interp_c, ics, pf_m)
    _check_dtypes("m4mb_audio_f32", *[(t, torch.float32) for t in ins])
    if bands.device.type == "cpu":
        return m4mb_audio_f32_ref(cfg, *ins)
    _check_cuda("m4mb_audio_f32", bands, *[(t, torch.float32) for t in ins], align=4)
    _check_mb_audio_shapes("m4mb_audio_f32", cfg, *ins)
    out = _launch_mb_audio(cfg, *ins)
    m4mb_audio_f32.launches += 1
    return out


m4mb_audio_f32.launches = 0


# csrc/m4mb_audio.cu's tiles: a warp of 32 segments of 8 samples a lane
MB_AUDIO_TILE = 256


def _launch_mb_audio(cfg, bands, fb_buf, interp_c, ics, pf_m):
    """csrc/m4mb_audio.cu on checked tensors: one launch, tiles of
    MB_AUDIO_TILE samples of each stream over the card, the 26 allpasses
    carried across them through the look-back scratch (read with the phase
    flip only). Returns (sig, pf_m')."""
    from dsp_tpu_torch import kernels

    B = bands.shape[-3]
    sig = bands.new_empty((*bands.shape[:-2], cfg.n_sig))
    pf_out = torch.empty_like(pf_m)
    # a tile publishes the (a, b) maps of its 26 lanes, in its stream's slots
    S = bands.shape[0] if bands.dim() == 4 else 1
    scratch = kernels.lookback_scratch(bands, -(-B // MB_AUDIO_TILE) * S, 2 * 2 * N_BANDS)
    kernels.launch_m4mb_audio(cfg, bands, fb_buf, interp_c, ics, pf_m, sig, pf_out, scratch)
    return sig, pf_out


def m4mb_audio_f32_ref(cfg, bands, fb_buf, interp_c, ics, pf_m):
    """Plain PyTorch version of m4mb_audio_f32: m4mb_audio_ref on the
    upcast inputs, its outputs rounded to float32."""
    sig, pf = m4mb_audio_ref(cfg, *(t.double() for t in (bands, fb_buf, interp_c, ics, pf_m)))
    return sig.float(), pf.float()


def _check_mb_audio_shapes(name, cfg, bands, fb_buf, interp_c, ics, pf_m):
    lead = tuple(bands.shape[:-3])
    B = bands.shape[-3] if bands.dim() in (3, 4) else 0
    Nc = B // DOWNSAMPLE_FACTOR
    if (bands.dim() not in (3, 4) or tuple(bands.shape[-2:]) != (N_BANDS, 2)
            or B % DOWNSAMPLE_FACTOR or B == 0
            or tuple(fb_buf.shape) != (*lead, cfg.len, N_BANDS, 2)
            or tuple(interp_c.shape) != (*lead, 3, N_BANDS, N_SIG_MB)
            or tuple(ics.shape) != (*lead, Nc, 3, N_BANDS, N_SIG_MB)
            or tuple(pf_m.shape) != (*lead, N_BANDS, 2, 2)):
        raise ValueError(f"{name}: bands {tuple(bands.shape)}, fb_buf {tuple(fb_buf.shape)}, "
                         f"ics {tuple(ics.shape)}, pf_m {tuple(pf_m.shape)}")


def _sum_bands(x):
    """x [B, 13] summed over the bands from band 0 up (dsp_tpu's order)."""
    acc = x[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
    return acc


def m4mb_audio_ref(cfg, bands, fb_buf, interp_c, ics, pf_m):
    """Plain PyTorch version of m4mb_audio (matrix4_mb.py:569-620); bands
    [S, B, 13, 2] a stream at a time."""
    if bands.dim() == 4:
        return _stack_tree([m4mb_audio_ref(cfg, *(t[s] for t in (bands, fb_buf, interp_c, ics,
                                                                  pf_m)))
                            for s in range(bands.shape[0])])
    B = bands.shape[0]
    D = DOWNSAMPLE_FACTOR
    all_ics = torch.cat([interp_c[None], ics])  # [Nc + 1, 3, 13, 12]
    i = torch.arange(B, device=bands.device)
    t = (((i + 1) % D).to(bands.dtype) / D)[:, None, None]
    coefs = all_ics[(i + 1) // D]
    vals = (coefs[:, 2] * t + coefs[:, 1]) * t + coefs[:, 0]  # [B, 13, 12]
    delayed = torch.cat([fb_buf, bands])[:B]
    s0, s1 = delayed[:, :, 0], delayed[:, :, 1]
    b_l = s0 * vals[:, :, 0] + s1 * vals[:, :, 1]
    b_r = s0 * vals[:, :, 2] + s1 * vals[:, :, 3]
    b_ls = s0 * vals[:, :, 4] + s1 * vals[:, :, 5]
    b_rs = s0 * vals[:, :, 6] + s1 * vals[:, :, 7]
    b_ls_pf, b_rs_pf = b_ls, b_rs
    if cfg.phase_flip:
        st = torch.cat([pf_m[:, 0], pf_m[:, 1]])  # [26, 2]: the ls lanes, then the rs lanes
        sig2 = torch.cat([b_ls + 1e-15, b_rs + 1e-15], dim=1)
        st, y = _ap1_ref(st, sig2, torch.cat([vals[:, :, 8], vals[:, :, 9]], dim=1))
        b_ls_pf, b_rs_pf = y[:, :N_BANDS] - 1e-15, y[:, N_BANDS:] - 1e-15
        pf_m = torch.stack([st[:N_BANDS], st[N_BANDS:]], dim=1)
    eps = 1e-15 / 324
    outs = [_sum_bands(b_l), _sum_bands(b_r)]
    if cfg.direct_path:
        amb, dire = vals[:, :, 10], vals[:, :, 11]
        outs += [_sum_bands(b_ls_pf * amb) + eps, _sum_bands(b_rs_pf * amb) + eps,
                 _sum_bands(b_ls * dire) + eps, -_sum_bands(b_rs * dire) + eps]
    else:
        outs += [_sum_bands(b_ls_pf) + eps, _sum_bands(b_rs_pf) + eps]
    return torch.stack(outs, dim=1), pf_m
