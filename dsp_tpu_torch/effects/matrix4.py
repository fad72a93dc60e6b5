"""matrix4 effect: 2-to-4 (or 2-to-6 with direct_path) active matrix
surround upmixer (reference: matrix4.c), ported from dsp_tpu.effects.matrix4.

A block runs in four launches and a splice (ops/m4_engine.py):

  * the 500 Hz HP + 5 kHz LP band-limit of the selected pair, hp then lp,
    on K2, both stages in one launch (ops/iir.biquad_scan_series);
  * K11 ``m4_env``: the eight envelope EWMAs, decimated to the fs/32 ticks;
  * K9 + K10 ``m4_event``: the event engine and the background-weight
    smoother tick by tick, then the matrix coefficients, phase flip, direct
    pan and the parabolic interpolator's coefficient sets for every tick;
  * K12 + K13 ``m4_audio``: the interpolated matrix values, the
    lookahead-delayed 2 -> 4 matrix, the dynamic shelf and lowpass, the
    phase-flip allpasses and the output columns;
  * the carried lookahead line as a ``splice`` (ops/fft_conv.py).

Under float32 (dsp_tpu's float32 step, matrix4.py:391-423) the band-limit
is one blocked cascade on K1-df (``iir.lti_blocked_df``, an L = 128 plan,
or L = 1 where the block is not a multiple of 128) on the ``bpc`` state,
and its (hi, lo) output feeds the float32 forms of the other kernels
(``m4_env_f32``, ``m4_event_f32``, ``m4_audio_f32``, ``splice_f32``),
which carry the ``*_lo`` leaves; ``bp_m`` passes through untouched, as in
dsp_tpu. Under float64 ``bpc`` and the ``*_lo`` leaves pass through.

The state's leaves, dtypes and shapes are dsp_tpu's, so a checkpoint
crosses between the packages both ways. ``fade_p`` and ``disable`` are CPU
tensors: the host passes them to the kernels as scalars and toggles them
on a signal without reading the device. A step is ``_control`` (the
band-limit, the envelopes and the engine: everything that decides the
coefficient sets) and ``_audio``, split as dsp_tpu splits it, so that a
replay can put another control stream into the audio path.

With a stream axis (batched processing, CompiledChain.process_batch) x is
[S, B, C] and every leaf but ``fade_p`` and ``disable`` is led by S: the S
streams are the event engine's lanes, and each launch runs them all.

Config options (status/matrix/shelf/lowpass/contour_pwrcmp/phase_flip/
signal/direct_path/rear_event_mask/surround_delay) follow
matrix4_config_init (matrix4_common.c:74-356).
"""

import numpy as np
import torch

from dsp_tpu_torch.core import log
from dsp_tpu_torch.core.parse import ParseError, num_bits_set, parse_freq, parse_len, strtod
from dsp_tpu_torch.core.types import StreamInfo
from dsp_tpu_torch.effects import biquad as bq
from dsp_tpu_torch.effects.base import ChannelPick, Effect, EffectError, register_effect
from dsp_tpu_torch.ops import iir
from dsp_tpu_torch.ops import m4_engine as m4
from dsp_tpu_torch.ops.fft_conv import splice

FADE_TIME = 500.0
CS_INTERP_DELAY_FRAMES = 3 * m4.DOWNSAMPLE_FACTOR
N_INTERP = m4.N_INTERP


class Matrix4Config:
    def __init__(self):
        self.status_type = "none"
        self.surr_delay_frames = 0
        self.lookahead_frames = 0
        self.shelf_mult = float(np.sqrt(0.5))
        self.shelf_f0 = 500.0
        self.contour_pwrcmp = 1.0
        self.lowpass_f0 = 6000.0
        self.rear_ev_mask = 1.0
        self.do_phase_flip = True
        self.do_direct_path = False
        self.do_dpwr_decouple = True
        self.enable_signal = False
        self.fb_type = "elliptic"
        self.fb_stop = [35.0, 50.0]
        self.freq_mask = 0.0
        self.matrix_ver = "v4"
        self.matrix_param = 0.5
        self.surr_mult = [float(np.sqrt(0.5)), 1.0]
        self.c0 = 0
        self.c1 = 1


def _parse_bool(name, opt, arg):
    if arg is None or arg == "" or "true".startswith(arg.lower()):
        return True
    if "false".startswith(arg.lower()):
        return False
    raise EffectError(f"{name}: unrecognized argument to option '{opt}': {arg}")


def _set_fb_stop_default(cfg):
    if cfg.fb_type == "butterworth":
        cfg.fb_stop = [0.0, 0.0]
    elif cfg.fb_type in ("chebyshev1", "chebyshev2"):
        cfg.fb_stop = [25.0, 0.0]
    else:
        cfg.fb_stop = [35.0, 50.0]


def matrix4_config_init(name, istream, selector, argv, is_mb):
    """Port of matrix4_config_init (matrix4_common.c:74-356)."""
    if istream.fs < 32000:
        raise EffectError(f"{name}: input sample rate out of range")
    if num_bits_set(selector) != 2:
        raise EffectError(f"{name}: input channels must be 2")
    cfg = Matrix4Config()
    if log.loglevel(log.LL_VERBOSE):
        cfg.status_type = "bars"
    cfg.surr_delay_frames = m4.time_to_frames(15.0, istream.fs)
    lookahead = 0.9 if is_mb else 0.6
    cfg.lookahead_frames = m4.time_to_frames(
        m4.EVENT_SAMPLE_TIME + m4.RISE_TIME_FAST * lookahead, istream.fs
    )
    cfg.contour_pwrcmp = 1.0
    cfg.rear_ev_mask = 0.3 if is_mb else 1.0
    surr_level = [None, None]
    for i, a in enumerate(argv[1:]):
        v, rest = strtod(a)
        if rest == "" or rest.startswith("/"):
            if rest != a:
                if a[0] != "/":
                    surr_level[0] = v
            if rest.startswith("/"):
                v2, rest2 = strtod(rest[1:])
                if rest2 or rest[1:] == "":
                    raise EffectError(f"{name}: failed to parse surround_level_rear")
                surr_level[1] = v2
            elif surr_level[0] is not None:
                surr_level[1] = min(surr_level[0] + 6.02, 0.0)
            if i != len(argv) - 2:
                raise EffectError(f"{name}: usage: surround level must be the last argument")
        else:
            for opt in a.split(","):
                opt = opt.strip()
                if not opt:
                    continue
                key, _, val = opt.partition("=")
                has_val = "=" in opt
                if key in ("status", "show_status"):
                    if not has_val or val in ("", "bars"):
                        cfg.status_type = "bars"
                    elif val == "text":
                        cfg.status_type = "text"
                    elif val == "none":
                        cfg.status_type = "none"
                    else:
                        raise EffectError(f"{name}: unrecognized status type: {val}")
                elif key == "matrix":
                    if not val:
                        raise EffectError(f"{name}: option requires argument: {opt}")
                    mv, _, mp = val.partition(":")
                    if mv == "v1":
                        cfg.matrix_ver = "v1"
                    elif mv == "v2":
                        cfg.matrix_ver, cfg.matrix_param = "v4", 0.0
                    elif mv == "v3":
                        cfg.matrix_ver, cfg.matrix_param = "v4", 1.0
                    elif mv == "v4":
                        cfg.matrix_ver, cfg.matrix_param = "v4", 0.5
                        if mp:
                            p, rest2 = strtod(mp)
                            if rest2 or not (0.0 <= p <= 1.0):
                                raise EffectError(f"{name}: matrix: v4: bad param")
                            cfg.matrix_param = p
                    else:
                        raise EffectError(f"{name}: unrecognized matrix identifier: {val}")
                elif key == "shelf":
                    if not val:
                        raise EffectError(f"{name}: option requires argument: {opt}")
                    g, _, rest_args = val.partition(":")
                    f0s, _, pw = rest_args.partition(":")
                    if g:
                        if g == "none":
                            cfg.shelf_mult = 1.0
                        else:
                            gv, r2 = strtod(g)
                            if r2:
                                raise EffectError(f"{name}: shelf: bad gain")
                            if gv > 0.0:
                                log.error("%s: warning: shelf gain probably shouldn't be greater than 0dB", name)
                            cfg.shelf_mult = 10.0 ** (gv / 20.0)
                    if f0s:
                        try:
                            cfg.shelf_f0 = parse_freq(f0s)
                        except ParseError:
                            raise EffectError(f"{name}: shelf: bad f0")
                        if not (100.0 <= cfg.shelf_f0 <= 6000.0):
                            raise EffectError(f"{name}: shelf: f0 out of range")
                    if pw:
                        pv, r2 = strtod(pw)
                        if r2 or not (0.0 <= pv <= 1.0):
                            raise EffectError(f"{name}: shelf: bad pwrcmp")
                        cfg.contour_pwrcmp = pv
                elif key == "lowpass":
                    if not val:
                        raise EffectError(f"{name}: option requires argument: {opt}")
                    if val == "none":
                        cfg.lowpass_f0 = 0.0
                    else:
                        try:
                            cfg.lowpass_f0 = parse_freq(val)
                        except ParseError:
                            raise EffectError(f"{name}: lowpass: bad f0")
                        if not (0.0 <= cfg.lowpass_f0 < istream.fs / 2.0):
                            raise EffectError(f"{name}: lowpass: f0 out of range")
                elif key == "contour_pwrcmp":
                    pv, r2 = strtod(val)
                    if not val or r2 or not (0.0 <= pv <= 1.0):
                        raise EffectError(f"{name}: bad {key}")
                    cfg.contour_pwrcmp = pv
                elif key == "phase_flip":
                    cfg.do_phase_flip = _parse_bool(name, key, val if has_val else None)
                elif key == "signal":
                    cfg.enable_signal = _parse_bool(name, key, val if has_val else None)
                elif key == "direct_path":
                    cfg.do_direct_path = _parse_bool(name, key, val if has_val else None)
                elif key == "rear_event_mask":
                    pv, r2 = strtod(val)
                    if not val or r2 or not (0.0 <= pv <= 100.0):
                        raise EffectError(f"{name}: bad {key}")
                    cfg.rear_ev_mask = pv
                elif key == "surround_delay":
                    if not val:
                        raise EffectError(f"{name}: option requires argument: {opt}")
                    try:
                        cfg.surr_delay_frames = parse_len(val, istream.fs)
                    except ParseError:
                        raise EffectError(f"{name}: bad surround_delay")
                elif key == "filter_type":
                    if not is_mb:
                        log.error("%s: warning: ignoring option: %s", name, opt)
                        continue
                    if not val:
                        raise EffectError(f"{name}: option requires argument: {opt}")
                    ft, _, stops = val.partition(":")
                    if ft not in ("butterworth", "chebyshev1", "chebyshev2", "elliptic"):
                        raise EffectError(f"{name}: unrecognized filter bank type: {val}")
                    cfg.fb_type = ft
                    _set_fb_stop_default(cfg)
                    if stops:
                        s0, _, s1 = stops.partition(":")
                        v0, r2 = strtod(s0)
                        if r2:
                            raise EffectError(f"{name}: bad stop_dB")
                        if ft in ("chebyshev1", "chebyshev2"):
                            if v0 < 10.0:
                                raise EffectError(f"{name}: stopband attenuation must be at least 10dB")
                            cfg.fb_stop[0] = v0
                        elif ft == "elliptic":
                            cfg.fb_stop[0] = v0
                            if s1:
                                v1, r3 = strtod(s1)
                                if r3:
                                    raise EffectError(f"{name}: bad stop_dB")
                                cfg.fb_stop[1] = v1
                            else:
                                cfg.fb_stop[1] = v0
                            if cfg.fb_stop[0] < 20.0 or cfg.fb_stop[1] < 20.0:
                                raise EffectError(f"{name}: stopband attenuation must be at least 20dB")
                elif key == "freq_mask":
                    if not is_mb:
                        log.error("%s: warning: ignoring option: %s", name, opt)
                        continue
                    pv, r2 = strtod(val)
                    if not val or r2 or not (0.0 <= pv <= 1.0):
                        raise EffectError(f"{name}: bad {key}")
                    cfg.freq_mask = pv
                elif key == "lookahead":
                    pv, r2 = strtod(val)
                    if not val or r2 or not (0.0 <= pv <= 2.0):
                        raise EffectError(f"{name}: bad {key}")
                    cfg.lookahead_frames = m4.time_to_frames(
                        m4.EVENT_SAMPLE_TIME + m4.RISE_TIME_FAST * pv, istream.fs
                    )
                elif key == "dpwr_decouple":
                    cfg.do_dpwr_decouple = _parse_bool(name, key, val if has_val else None)
                else:
                    raise EffectError(f"{name}: unrecognized option: {opt}")
    cfg.surr_mult[0] = float(np.sqrt(0.5)) if surr_level[0] is None else 10.0 ** (surr_level[0] / 20.0)
    cfg.surr_mult[1] = 1.0 if surr_level[1] is None else 10.0 ** (surr_level[1] / 20.0)
    if cfg.surr_mult[0] > 1.0 or cfg.surr_mult[1] > 1.0:
        log.error("%s: warning: surround levels probably shouldn't be greater than 0dB", name)
    if cfg.surr_mult[0] > cfg.surr_mult[1]:
        log.error("%s: warning: surround_level_rear probably shouldn't be lower than surround_level", name)
    sel = np.flatnonzero(np.asarray(selector, dtype=bool))
    cfg.c0, cfg.c1 = int(sel[0]), int(sel[1])
    return cfg


class Matrix4Effect(Effect):
    # adaptive event engine: multi-second ring buffers and discrete
    # decisions make zero-state priming content-dependent, not bounded
    split_safe = False
    host_leaves = frozenset({"fade_p", "disable"})

    def __init__(self, name, istream, selector, argv):
        cfg = matrix4_config_init(name, istream, selector, argv, is_mb=False)
        self.cfg = cfg
        self.name = name
        self.istream = istream
        n_extra = 4 if cfg.do_direct_path else 2
        self.ostream = StreamInfo(istream.fs, istream.channels + n_extra)
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.block_quantum = m4.DOWNSAMPLE_FACTOR
        fs = istream.fs
        fs_ds = fs / m4.DOWNSAMPLE_FACTOR
        self.ev_params = m4.make_event_params(fs_ds, 1.0, 0.7, cfg.rear_ev_mask)
        # band-limit filters (matrix4.c:402-403)
        hp = np.array(bq.normalize(*bq.design(bq.HIGHPASS, fs, 500.0, 0.5)))
        lp = np.array(bq.normalize(*bq.design(bq.LOWPASS, fs, 5000.0, 0.5)))
        self.A_hp, self.B_hp, self.c0_hp = iir.biquad_coeffs_to_ss(np.stack([hp, hp], axis=1))
        self.A_lp, self.B_lp, self.c0_lp = iir.biquad_coeffs_to_ss(np.stack([lp, lp], axis=1))
        # the two stages as biquad_scan_series takes them: hp rows, then lp
        self.A_bl, self.B_bl, self.c0_bl = (np.concatenate([h, l]) for h, l in (
            (self.A_hp, self.A_lp), (self.B_hp, self.B_lp), (self.c0_hp, self.c0_lp)))
        self.bp_c = np.stack([hp, hp, lp, lp], axis=1)  # the float32 path's cascade
        self.g_env = float(m4.ewma_g(fs, m4.ENV_SMOOTH_TIME))
        # dynamic shelf params (matrix4.c:79-87)
        self.shelf = self._dyn_shelf_params(fs, cfg.shelf_f0)
        self.lowpass = self._dyn_shelf_params(fs, cfg.lowpass_f0 if cfg.lowpass_f0 > 0 else 6000.0)
        if cfg.lowpass_f0 > 0.0:
            lp_f = (fs + cfg.lowpass_f0) / 2.0
            self.lowpass_mult = float(np.sqrt(1.0 / (1.0 + (lp_f * lp_f / (cfg.lowpass_f0 * cfg.lowpass_f0)))))
        else:
            self.lowpass_mult = 1.0
        self.shelf_mult = cfg.shelf_mult
        # smf for background cs weight (matrix4.c:409-410)
        self.bg_g0 = float(1.0 - np.exp(-1.0 / (fs_ds * (m4.ACCOM_TIME * 2.0 / 1000.0 / 2.1972))))
        self.bg_c0 = 0.01 * 4.0
        self.bg_c1 = 1e-6 * 4.0
        # phase flip params (matrix4_common.c:469-473)
        self.pf_c0 = 0.667829372575655
        self.pf_c1 = float(np.log(0.0005 * (44100.0 / fs)))
        self.fade_frames = m4.time_to_frames(FADE_TIME, fs)
        self.len = cfg.lookahead_frames + CS_INTERP_DELAY_FRAMES
        self.surr_delay_frames = cfg.surr_delay_frames
        self.ctl = m4.M4Control(
            self.ev_params, self.bg_g0, self.bg_c0, self.bg_c1,
            matrix_v4=cfg.matrix_ver == "v4", matrix_param=cfg.matrix_param,
            dpwr_decouple=cfg.do_dpwr_decouple, surr_mult=cfg.surr_mult,
            contour_pwrcmp=cfg.contour_pwrcmp, shelf_mult=self.shelf_mult,
            lowpass_mult=self.lowpass_mult, pf_c0=self.pf_c0, pf_c1=self.pf_c1,
            fade_frames=self.fade_frames,
        )
        self.audio = m4.M4Audio(cfg.c0, cfg.c1, istream.channels, self.len, self.shelf,
                                self.shelf_mult != 1.0, self.lowpass, self.lowpass_mult != 1.0,
                                cfg.do_phase_flip, cfg.do_direct_path)
        self._pair = ChannelPick([cfg.c0, cfg.c1], istream.channels)
        self._statusline = None
        self._signal_flag = False

    def _bp_plan(self, block):
        """The float32 band-limit's blocked plan (dsp_tpu's _bp_plan): L =
        128 when the block fits the chunked kernel, else L = 1."""
        L = iir.BLOCKED_L if (block % iir.BLOCKED_L == 0 and block >= 2 * iir.BLOCKED_L) else 1
        plans = self.__dict__.setdefault("_bp_plans", {})
        if L not in plans:
            plans[L] = iir.CascadeBlockedPlan([self.bp_c[:, :2], self.bp_c[:, 2:]], L=L)
        return plans[L]

    @staticmethod
    def _dyn_shelf_params(fs, f0):
        w0 = 2 * np.pi * f0 / fs
        sin_w0 = np.sin(w0)
        cos_w0_p1 = np.cos(w0) + 1.0
        norm = 1.0 / (sin_w0 + cos_w0_p1)
        c2 = (sin_w0 - cos_w0_p1) * norm
        return {"sin_w0": float(sin_w0), "cos_w0_p1": float(cos_w0_p1), "norm": float(norm), "c2": float(c2)}

    def state0(self):
        p = self.ev_params
        init_interp = np.zeros(N_INTERP)
        init_interp[0] = init_interp[3] = 1.0  # ll, rr identity-ish startup
        # C initializes BOTH interps from phase_flip_pos_rs of the zero
        # axes = 0.5 (matrix4.c:412-414)
        pf0 = np.exp(0.5 * (self.pf_c1 - self.pf_c0) + self.pf_c0) - 1.0
        pf1 = pf0
        init_interp[12], init_interp[13] = pf0, pf1
        init_interp[14] = 1.0  # m_surr_amb
        st = {
            "ev": m4.make_event_state(p),
            # the float32 path's lo parts (carried untouched under float64)
            "ev_lo": m4.make_event_state_lo(p),
            "env_m_lo": np.zeros(8, dtype=np.float32),
            "bg_cs_lo": np.zeros(2, dtype=np.float32),
            "bp_m": np.zeros((4, 2)),  # band-limit biquad memories (float64)
            # the float32 band-limit: the hp + lp cascade's (hi, lo) state
            "bpc": np.zeros((2, 2, 4)),
            "env_m": np.zeros(8),  # envelope EWMAs
            "bg_cs": np.array([1.0, 1.0]),  # smf state (m0, m1)
            "interp_y": np.tile(init_interp, (4, 1)),  # parabolic window
            "interp_c": np.stack([init_interp, np.zeros(N_INTERP), np.zeros(N_INTERP)]),
            "buf": np.zeros((self.len, 2)),  # lookahead delay
            "shelf_m": np.zeros(4),  # front L/R, surr L/R dyn shelf memories
            "lp_m": np.zeros(4),
            "pf_m": np.zeros((2, 2)),  # ap1 (i0, o0) per surround channel
            # read and written by the host every block: CPU tensors
            "fade_p": torch.tensor(0, dtype=torch.int64),
            "disable": torch.tensor(False),
        }
        return st

    def state_for_block(self, B):
        st = self.state0()
        # per-block steering display data, threaded through the state for
        # host_update (dsp_tpu's leaf)
        st["aux"] = np.zeros((B // m4.DOWNSAMPLE_FACTOR, 4))
        return st

    def signal(self):
        # the reference only installs the handler when the `signal` option
        # is given (matrix4.c:396): 's'/SIGUSR2 must not toggle otherwise
        if self.cfg.enable_signal:
            self._signal_flag = True
        return None

    def step(self, state, x):
        return self._audio(state, x, self._control(state, x))

    def _control(self, state, x):
        """The band-limit, the envelopes and the engine (K2 or K1-df, K11,
        K9 + K10): the state leaves they carry, and the block's coefficient
        sets ``ics`` [Nc, 3, 16] and display values ``aux`` [Nc, 4] (each
        led by S with a stream axis)."""
        pair = self._pair.take(x).contiguous()  # [B, 2]: the selected channels
        fade_p, disable = int(state["fade_p"]), bool(state["disable"])  # CPU tensors
        # the engine's lanes: one for one stream, else the S streams
        if x.dim() == 2:
            lanes, unlane = (lambda v: v[None]), (lambda v: v[0])
        else:
            lanes = unlane = (lambda v: v)
        ev = {k: lanes(v) for k, v in state["ev"].items()}
        if x.dtype == torch.float32:
            bpc, (y_hi, y_lo) = iir.lti_blocked_df(self._bp_plan(x.shape[-2]), state["bpc"], pair)
            env_m, env_m_lo, env_ds = m4.m4_env_f32(y_hi, y_lo, state["env_m"], state["env_m_lo"],
                                                    self.g_env)
            ev, ev_lo, bg, bg_lo, ics, iy, aux = m4.m4_event_f32(
                self.ctl, ev, {k: lanes(v) for k, v in state["ev_lo"].items()},
                lanes(state["bg_cs"]), lanes(state["bg_cs_lo"]), lanes(env_ds),
                lanes(state["interp_y"]), fade_p, disable)
            ctl = {"bpc": bpc, "env_m_lo": env_m_lo,
                   "ev_lo": {k: unlane(v) for k, v in ev_lo.items()}, "bg_cs_lo": unlane(bg_lo)}
        else:
            bp_m, y_bp = iir.biquad_scan_series(
                *(self.device_array(k, x) for k in ("A_bl", "B_bl", "c0_bl")), state["bp_m"], pair)
            env_m, env_ds = m4.m4_env(y_bp, state["env_m"], self.g_env)
            ev, bg, ics, iy, aux = m4.m4_event(self.ctl, ev, lanes(state["bg_cs"]), lanes(env_ds),
                                               lanes(state["interp_y"]), fade_p, disable)
            ctl = {"bp_m": bp_m}
        ctl.update(ev={k: unlane(v) for k, v in ev.items()}, env_m=env_m, bg_cs=unlane(bg),
                   interp_y=unlane(iy), ics=unlane(ics), aux=unlane(aux))
        return ctl

    def _audio(self, state, x, ctl):
        """The lookahead-delayed matrix, the dynamic shelf and lowpass and
        the phase-flip allpasses (K12 + K13), and the lookahead line's
        splice, from ctl (_control's result)."""
        B = x.shape[-2]
        pair = self._pair.take(x).contiguous()
        audio = m4.m4_audio_f32 if x.dtype == torch.float32 else m4.m4_audio
        ics = ctl["ics"]
        y, shelf_m, lp_m, pf_m = audio(self.audio, x, state["buf"], state["interp_c"], ics,
                                       state["shelf_m"], state["lp_m"], state["pf_m"])
        fade_p = int(state["fade_p"])
        new_state = dict(
            state,
            **{k: v for k, v in ctl.items() if k not in ("ics", "aux")},
            interp_c=ics[..., -1, :, :].contiguous(),  # a copy only with a stream axis
            buf=splice(state["buf"], pair, self.len, self.len - B, B),
            shelf_m=shelf_m,
            lp_m=lp_m,
            pf_m=pf_m,
            fade_p=torch.tensor(max(fade_p - B, 0), dtype=torch.int64),
        )
        if "aux" in state:
            new_state["aux"] = ctl["aux"]
        return new_state, y

    # --- chain hooks ---

    def channel_deps(self):
        n_in = self.istream.channels
        n_out = self.ostream.channels
        deps = np.zeros((n_out, n_in), dtype=bool)
        for i in range(min(n_in, n_out)):
            deps[i, i] = True
        deps[self.cfg.c0, self.cfg.c1] = True
        deps[self.cfg.c1, self.cfg.c0] = True
        for i in range(n_in, n_out):
            deps[i, self.cfg.c0] = True
            deps[i, self.cfg.c1] = True
        return deps

    def channel_offsets(self):
        n_in = self.istream.channels
        n_out = self.ostream.channels
        lat = np.zeros(n_out, dtype=np.int64)
        req = np.zeros(n_out, dtype=np.int64)
        lat[self.cfg.c0] = self.len
        lat[self.cfg.c1] = self.len
        ns = n_out - n_in
        nds = ns // 2 if self.cfg.do_direct_path else ns
        for i in range(n_in, n_out):
            lat[i] = self.len
        for i in range(n_in, n_in + nds):
            req[i] = self.surr_delay_frames
        return lat, req

    def drain_samples(self, samples):
        samples[self.cfg.c0] += self.len
        samples[self.cfg.c1] += self.len
        for i in range(self.istream.channels, self.ostream.channels):
            samples[i] += self.len

    def host_update(self, state):
        if self._signal_flag:
            self._signal_flag = False
            # toggled on the host: flip disable and restart the fade; both
            # are CPU tensors, so nothing waits on the device
            state["disable"] = torch.logical_not(state["disable"])
            state["fade_p"] = torch.tensor(self.fade_frames - int(state["fade_p"]), dtype=torch.int64)
        if self.cfg.status_type != "none" and "aux" in state:
            from dsp_tpu_torch.cli import terminal

            aux = state["aux"].to("cpu").numpy()  # the status line's one device read
            if self._statusline is None:
                self._statusline = terminal.Statusline()
                terminal.register(self._statusline)
            self._statusline.set(self.status_text(aux, bool(state["disable"])))

    def status_text(self, aux, disabled):
        """The status line for the last tick of `aux` [Nc, 4] (text or bars)."""
        lr, cs = aux[-1, 0], aux[-1, 1]
        off = " [off]" if disabled else ""
        if self.cfg.status_type == "text":
            return (f"{self.name}{off}: lr: {np.degrees(lr):+06.2f} ({np.degrees(aux[-1, 2]):+06.2f}); "
                    f"cs: {np.degrees(cs):+06.2f} ({np.degrees(aux[-1, 3]):+06.2f})")
        return f"{self.name}{off}: L[{draw_steering_bar(lr)}]R; C[{draw_steering_bar(cs)}]S"

    def host_finish(self, state):
        from dsp_tpu_torch.cli import terminal

        if self._statusline is not None:
            terminal.unregister(self._statusline)
            self._statusline = None


def matrix4_effect_init(ei, istream, selector, dir_, argv):
    return Matrix4Effect(argv[0], istream, selector, argv)


register_effect(
    "matrix4",
    "matrix4 [options ...] [surround_level][/surround_level_rear]",
    matrix4_effect_init,
)


def draw_steering_bar(a, is_event=False):
    """31-char steering bar (matrix4_common.c:981-1002)."""
    s = [" "] * 31
    i = int(round(float(a) * (-15 / m4.M_PI_4))) + 15
    i = min(max(i, 0), 30)
    cursor_c = "#" if is_event else "*"
    fill_c = "=" if is_event else "-"
    if i > 15:
        for j in range(15, i):
            s[j] = fill_c
    elif i < 15:
        for j in range(i + 1, 15):
            s[j] = fill_c
    s[i] = cursor_c
    return "".join(s)
