"""matrix4_mb effect: the 13-band multiband active matrix surround upmixer
(reference: matrix4_mb.c), ported from dsp_tpu.effects.matrix4_mb in
float64.

The selected pair goes through the fshape pre-emphasis, a 13-band tree of
CAP5 crossovers, an event engine a band at fs/32 whose thresholds the
bands modulate together every tick, a 2 -> 4 matrix a band on the
lookahead-delayed band signals, the band sums and the inverse fshape. A
linear-phase FIR that equalises the bank's phase runs before it as a
separate fir effect (matrix4_mb_effect_init). A block runs in nine launches
and a splice:

  * the fshape's two biquads in one launch (ops/iir.biquad_scan_run, K2 a
    stage), coupled form;
  * the whole bank on K1 (ops/iir.lti_blocked): the tree composed on the
    host into one 40-state system a band and channel (26 lanes), in chunks
    of L = 128, or L = 1 for blocks that are not a multiple of 128 or are
    under 256;
  * K11 ``m4mb_env``: the frequency-mask mix and the eight envelope EWMAs of
    every band, decimated to the ticks;
  * K9 + K10 ``m4mb_event``: the 13 engines in lockstep with the cross-band
    threshold modulation, then each tick's and band's matrix values and the
    interpolator's coefficient sets;
  * K12 + K13 ``m4mb_audio``: the interpolated values, the delayed bands
    through their matrices, the band sums, the phase-flip allpasses over
    26 lanes and the direct path;
  * the inverse fshape's two biquads in one launch over 4 or 6 signals;
  * the carried lookahead line as a ``splice`` (ops/fft_conv.py).

Under float32 (dsp_tpu's float32 _control and _audio, matrix4_mb.py:338-349,
:616-622, :255-275) the fshape and its inverse run on K3
(``iir.biquad_scan_run_df``, the coupled form, each stage's state handed
in and out as one float32 array, as dsp_tpu's biquad_scan_auto does), the bank
on K1-df with its (hi, lo) output (``iir.lti_blocked_df``): the pair feeds
the envelopes, hi the audio path and the lookahead line. The float32 forms
``m4mb_env_f32``, ``m4mb_event_f32``, ``m4mb_audio_f32`` and ``splice_f32``
carry the ``*_lo`` leaves (``ev_lo``, ``ev_thresh_lo``, ``env_m_lo``), which
float64 passes through untouched.

With a stream axis (batched processing, CompiledChain.process_batch) x is
[S, B, C] and every leaf but ``fade_p`` and ``disable`` is led by S (the
event state [S, 13, ...]); each launch runs the S streams.

The state's leaves, dtypes and shapes are dsp_tpu's, so a checkpoint
crosses between the packages both ways. The bank is always the fused one: dsp_tpu's sequential
per-cap bank (state0's dict of ``a1``, ``a2p``, ``a2o``, ``comp``) is not
ported, and a checkpoint that carries it does not load.
"""

import numpy as np
import torch

from dsp_tpu_torch.core import log
from dsp_tpu_torch.core.types import StreamInfo
from dsp_tpu_torch.effects import biquad as bq
from dsp_tpu_torch.effects.base import ChannelPick, Effect, register_effect
from dsp_tpu_torch.effects.fir import FirEffect
from dsp_tpu_torch.effects.matrix4 import (CS_INTERP_DELAY_FRAMES, FADE_TIME, draw_steering_bar,
                                           matrix4_config_init)
from dsp_tpu_torch.ops import cap5 as c5
from dsp_tpu_torch.ops import iir
from dsp_tpu_torch.ops import m4_engine as m4
from dsp_tpu_torch.ops.fft_conv import splice

N_BANDS = c5.N_BANDS
BASE_ORD_NOTCH_SCALE_F0 = 700.0
EVENT_THRESH_MAX = 3.6
EVENT_THRESH_MIN = 1.4
BAND_WEIGHT_IDX_MULT = 0.95
PHASE_LIN_MAX_LEN = 50.0
PHASE_LIN_TRUNC_THRESH = 1e-6
N_SIG = m4.N_SIG_MB  # ll lr rl rr lsl lsr rsl rsr pf0 pf1 amb dir

FSHAPE_LF = (10.0, np.sqrt(0.5), 180.0, 0.4)
FSHAPE_HF = (0.46, 0.5, 14000.0, 0.5)  # [0] multiplied by fs


def _fshape_coeffs(fs, inv):
    """Two-biquad pre-emphasis (matrix4_mb.c:131-148). -> [5, 2] columns lf,hf."""
    lf = FSHAPE_LF
    hf = (FSHAPE_HF[0] * fs, FSHAPE_HF[1], FSHAPE_HF[2], FSHAPE_HF[3])
    if inv:
        lf_c = bq.normalize(*bq.design(bq.HIGHPASS_TRANSFORM, fs, lf[2], lf[3], lf[0], lf[1]))
        hf_c = bq.normalize(*bq.design(bq.LOWPASS_TRANSFORM, fs, hf[2], hf[3], hf[0], hf[1]))
    else:
        lf_c = bq.normalize(*bq.design(bq.HIGHPASS_TRANSFORM, fs, lf[0], lf[1], lf[2], lf[3]))
        hf_c = bq.normalize(*bq.design(bq.LOWPASS_TRANSFORM, fs, hf[0], hf[1], hf[2], hf[3]))
    return np.stack([np.array(lf_c), np.array(hf_c)], axis=1)


def _cascade_stages(coeffs, lanes):
    """The two stages of a [5, 2] cascade on `lanes` lanes as
    iir.biquad_scan_run's table (A [2, lanes, 2, 2], Bv [2, lanes, 2], c0
    [2, lanes]), in the coupled form dsp_tpu's biquad_scan_auto runs."""
    stages = []
    for s_i in range(2):
        cmat = np.tile(coeffs[:, s_i][:, None], (1, lanes))
        A, Bv = iir._coupled_form_ss(cmat)
        stages.append((A, Bv, cmat[0].copy()))
    return tuple(np.stack(a) for a in zip(*stages))


class Matrix4MbEffect(Effect):
    split_safe = False  # see Matrix4Effect: adaptive event engine
    host_leaves = frozenset({"fade_p", "disable"})
    def __init__(self, name, istream, selector, argv):
        cfg = matrix4_config_init(name, istream, selector, argv, is_mb=True)
        self.cfg = cfg
        self.name = name
        self.istream = istream
        n_extra = 4 if cfg.do_direct_path else 2
        self.ostream = StreamInfo(istream.fs, istream.channels + n_extra)
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.block_quantum = m4.DOWNSAMPLE_FACTOR
        fs = istream.fs
        fs_ds = fs / m4.DOWNSAMPLE_FACTOR

        # per-band event params stacked along axis 0
        self.ev_thresh_max = np.zeros(N_BANDS)
        self.ev_thresh_min = np.zeros(N_BANDS)
        per_band = []
        for k in range(N_BANDS):
            xw = max(k - 1, 0) * 0.15 * BAND_WEIGHT_IDX_MULT
            mult = 1.0 - (xw / (xw + 1.0)) * 1.46 * 0.6
            self.ev_thresh_max[k] = EVENT_THRESH_MAX * mult
            self.ev_thresh_min[k] = EVENT_THRESH_MIN * mult
            ns_fc = c5.FB_FC_13[k] / BASE_ORD_NOTCH_SCALE_F0
            per_band.append(
                m4.make_event_params(
                    fs_ds,
                    base_thresh_scale=self.ev_thresh_max[k] / m4.EVENT_THRESH,
                    base_ord_notch_scale=np.exp(-3.465735902799727e-01 * ns_fc * ns_fc),
                    rear_ev_mask=cfg.rear_ev_mask,
                    norm_accom_factor=0.6,
                    diff_overshoot=1.01,
                )
            )
        self.ev_params = {
            k: np.stack([np.asarray(p[k], dtype=np.float64) for p in per_band])
            if not isinstance(per_band[0][k], dict)
            else {kk: np.stack([np.asarray(p[k][kk]) for p in per_band]) for kk in per_band[0][k]}
            for k in per_band[0]
        }
        # integer params stay scalar (they index and bound loops)
        for k in m4.INT_PARAMS:
            self.ev_params[k] = per_band[0][k]
        self.g_ev_thresh = float(m4.ewma_g(fs_ds, m4.EVENT_SAMPLE_TIME))
        self.g_env = float(m4.ewma_g(fs, m4.ENV_SMOOTH_TIME))

        # filter bank
        self.caps, self.comp = c5.build_filter_bank(fs, cfg.fb_type, cfg.fb_stop)
        self.fshape_c = _fshape_coeffs(fs, inv=False)
        self.inv_fshape_c = _fshape_coeffs(fs, inv=True)

        # band contour (matrix4_mb.c:738-751)
        shelf_mult2 = cfg.shelf_mult**2
        self.contour = np.zeros(N_BANDS)
        for k in range(N_BANDS):
            fc2 = c5.FB_FC_13[k] ** 2
            f2 = fc2 / cfg.shelf_f0**2
            self.contour[k] = np.sqrt((1.0 + shelf_mult2 * f2) / (1.0 + f2))
            if cfg.lowpass_f0 > 0.0:
                self.contour[k] *= np.sqrt(1.0 / (1.0 + fc2 / cfg.lowpass_f0**2))

        self.pf_c0 = 0.667829372575655
        self.pf_c1 = float(np.log(0.0005 * (44100.0 / fs)))
        self.fade_frames = m4.time_to_frames(FADE_TIME, fs)
        self.fb_buf_len = cfg.lookahead_frames + CS_INTERP_DELAY_FRAMES
        self.surr_delay_frames = cfg.surr_delay_frames
        self._signal_flag = False
        self._statuslines = None

        # phase-linearization FIR (matrix4_mb.c:757-786)
        phase_lin_frames = m4.time_to_frames(PHASE_LIN_MAX_LEN, fs)
        bank = c5.NumpyBank(self.caps, self.comp)
        filt = np.zeros(phase_lin_frames)
        for i in range(phase_lin_frames - 1, -1, -1):
            bands = bank.run_sample(1.0 if i == phase_lin_frames - 1 else 0.0)
            filt[i] = bands.sum()
        zx = 0
        integ = abs(filt[0])
        trunc = PHASE_LIN_TRUNC_THRESH * PHASE_LIN_TRUNC_THRESH * fs
        k = 1
        while integ < trunc and k < phase_lin_frames:
            if np.signbit(filt[k]) != np.signbit(filt[k - 1]):
                zx = k
                integ = 0.0
            integ += abs(filt[k])
            k += 1
        self.phase_lin_filter = filt[zx:].copy()
        self.len = self.fb_buf_len + (len(self.phase_lin_filter) - 1)
        log.verbose("%s: info: phase-lin FIR length %d", name, len(self.phase_lin_filter))

        self.ctl = m4.M4MbControl(
            self.ev_params, self.ev_thresh_max, self.ev_thresh_min, self.g_ev_thresh,
            self.contour, matrix_v4=cfg.matrix_ver == "v4", matrix_param=cfg.matrix_param,
            dpwr_decouple=cfg.do_dpwr_decouple, surr_mult=cfg.surr_mult,
            contour_pwrcmp=cfg.contour_pwrcmp, pf_c0=self.pf_c0, pf_c1=self.pf_c1,
            fade_frames=self.fade_frames,
        )
        self.audio = m4.M4MbAudio(self.fb_buf_len, cfg.do_phase_flip, cfg.do_direct_path)
        self.fmw = m4.band_mix_weights(cfg.freq_mask)
        # the cascades' coefficients: the fshape on the pair, its inverse on
        # the 4 or 6 signals
        for tag, coeffs, lanes in (("fsh", self.fshape_c, 2),
                                   ("inv", self.inv_fshape_c, self.audio.n_sig)):
            for k, a in zip(("A", "Bv", "c0"), _cascade_stages(coeffs, lanes)):
                setattr(self, f"{tag}_{k}", a)
        self._pair = ChannelPick([cfg.c0, cfg.c1], istream.channels)

    # --- state ---

    def state_for_block(self, block):
        st = self.state0()
        # per-band steering display data threaded through the state (read by
        # host_update), dsp_tpu's leaf
        st["aux"] = np.zeros((block // m4.DOWNSAMPLE_FACTOR, N_BANDS, 2))
        return st

    def state0(self):
        init_interp = np.zeros((N_BANDS, N_SIG))
        init_interp[:, 0] = init_interp[:, 3] = 1.0
        # both interps start from phase_flip_pos_rs(0, 0) = 0.5 (matrix4.c)
        pf0 = np.exp(0.5 * (self.pf_c1 - self.pf_c0) + self.pf_c0) - 1.0
        init_interp[:, 8] = pf0
        init_interp[:, 9] = pf0
        init_interp[:, 10] = 1.0
        base = m4.make_event_state({"buf_len": self.ev_params["buf_len"]})
        ev0 = {k: np.broadcast_to(v, (N_BANDS,) + np.shape(v)).copy() for k, v in base.items()}
        ev_lo = {
            k: np.zeros((N_BANDS,) + np.shape(v), dtype=np.float32)
            for k, v in base.items()
            if np.issubdtype(np.asarray(v).dtype, np.floating)
        }
        n = max(s["A"].shape[1] for s in self._band_systems())  # the bank's states a lane
        return {
            "ev": ev0,
            # dsp_tpu's float32 path's lo parts: carried untouched
            "ev_lo": ev_lo,
            "ev_thresh_lo": np.zeros(N_BANDS, dtype=np.float32),
            "env_m_lo": np.zeros((N_BANDS, 8), dtype=np.float32),
            "ev_thresh": self.ev_thresh_max.copy(),
            "fshape_m": np.zeros((4, 2)),  # lf+hf per channel
            "bank": {"fused": np.zeros((2, 2 * N_BANDS, n))},
            "env_m": np.zeros((N_BANDS, 8)),
            "interp_y": np.tile(init_interp[None], (4, 1, 1)),
            "interp_c": np.concatenate([init_interp[None], np.zeros((2, N_BANDS, N_SIG))], axis=0),
            "fb_buf": np.zeros((self.fb_buf_len, N_BANDS, 2)),
            "pf_m": np.zeros((N_BANDS, 2, 2)),
            "inv_fshape_m": np.zeros((self.audio.n_sig, 2, 2)),
            # read and written by the host every block: CPU tensors
            "fade_p": torch.tensor(0, dtype=torch.int64),
            "disable": torch.tensor(False),
        }

    def _band_systems(self):
        """Per-band LTI systems: each band's full CAP5-tree path composed
        host-side into one state space (iir.ss_* algebra), stacked as
        13 bands x 2 stereo lanes. The bank then runs as ONE blocked kernel."""
        def bq2(row):
            return iir.ss_from_biquad(np.stack([row, row], axis=1))

        sig = {"in": iir.ss_identity(2)}
        for op in c5.FB_PROGRAM_13:
            if op[0] == "cap5":
                _, fi, i_n, lp_n, hp_n = op
                cc = self.caps[fi]
                a1s = bq2(c5.ap2_biquad(*cc["a1"]))
                a2s = iir.ss_series(bq2(c5.ap2_biquad(*cc["a2_ap2"])), bq2(c5.ap1_biquad(cc["a2_ap1"])))
                base = sig[i_n]
                sig[lp_n] = iir.ss_series(base, iir.ss_scale(iir.ss_add(a1s, a2s, 1.0, 1.0), 0.5))
                sig[hp_n] = iir.ss_series(base, iir.ss_scale(iir.ss_add(a1s, a2s, 1.0, -1.0), 0.5))
            else:
                _, ai, s_n = op
                sig[s_n] = iir.ss_series(sig[s_n], bq2(c5.ap2_biquad(*self.comp[ai])))
        return [sig[f"s{k}"] for k in range(N_BANDS)]

    def _bank_plan(self, block):
        """Blocked-kernel plan for the whole 13-band tree: L = 128 when the
        block fits the chunked kernel, else L = 1 (the same kernel, a chunk
        a sample)."""
        L = iir.BLOCKED_L if (block % iir.BLOCKED_L == 0 and block >= 2 * iir.BLOCKED_L) else 1
        plans = self.__dict__.setdefault("_bank_plans", {})
        if L not in plans:
            plans[L] = iir.CascadeBlockedPlan.from_ss(iir.ss_stack(self._band_systems()), L=L)
        return plans[L]

    def signal(self):
        if self.cfg.enable_signal:  # matrix4_mb.c:686: no handler otherwise
            self._signal_flag = True
        return None

    # --- block step ---

    def _cascade(self, tag, st, x):
        """The two-biquad cascade `tag` ("fsh" or "inv") on x [B, C] from
        st [2, C, 2] (a stage a row): a view of the state as the effect
        keeps it (fshape_m [4, 2] reshaped, inv_fshape_m [n_sig, 2, 2]
        transposed); with a stream axis x [S, B, C] and st [S, 2, C, 2].
        Returns (st', y), st' the same view of a new state. One launch, the
        kernel reading and writing each stage's state in place
        (iir.biquad_scan_run): float64 on K2, float32 on K3 with a single
        float32 state a stage, as dsp_tpu's biquad_scan_auto."""
        A, Bv, c0 = (self.device_array(f"{tag}_{k}", x, torch.float64) for k in ("A", "Bv", "c0"))
        new = torch.empty_like(st)  # st's strides: the state's own layout
        _, y = iir.biquad_scan_run(A, Bv, c0, st.unbind(-3), x, out=new.unbind(-3))
        return new, y

    def step(self, state, x):
        return self._audio(state, x, self._control(state, x))

    def _control(self, state, x):
        """The fshape, the bank, the envelopes and the engines (K2 or K3, K1
        or K1-df, K11, K9 + K10): everything the audio path needs from the
        block's input. Split from _audio as dsp_tpu splits it, so that a
        replay can put another control stream (ics) into the audio path."""
        lead, B = x.shape[:-2], x.shape[-2]  # lead: (S,) with a stream axis
        pair = self._pair.take(x).contiguous()
        fsh, s_pre = self._cascade("fsh", state["fshape_m"].reshape(*lead, 2, 2, 2), pair)
        # cols: [b0L, b0R, b1L, ...]
        xt = s_pre.repeat(*(1,) * len(lead), 1, N_BANDS)
        w = None if self.fmw is None else self.device_array("fmw", x, torch.float64)
        fade_p, disable = int(state["fade_p"]), bool(state["disable"])  # CPU tensors
        if x.dtype == torch.float32:
            bst, (yb, yb_lo) = iir.lti_blocked_df(self._bank_plan(B), state["bank"]["fused"], xt)
            env_m, env_m_lo, env_ds = m4.m4mb_env_f32(
                yb.view(*lead, B, N_BANDS, 2), yb_lo.view(*lead, B, N_BANDS, 2), state["env_m"],
                state["env_m_lo"], self.g_env, w)
            ev, ev_lo, evt, evt_lo, ics, iy, aux = m4.m4mb_event_f32(
                self.ctl, state["ev"], state["ev_lo"], state["ev_thresh"], state["ev_thresh_lo"],
                env_ds, state["interp_y"], fade_p, disable)
            ctl = {"env_m_lo": env_m_lo, "ev_lo": ev_lo, "ev_thresh_lo": evt_lo}
        else:
            bst, yb = iir.lti_blocked(self._bank_plan(B), state["bank"]["fused"], xt)
            env_m, env_ds = m4.m4mb_env(yb.view(*lead, B, N_BANDS, 2), state["env_m"], self.g_env,
                                        w)
            ev, evt, ics, iy, aux = m4.m4mb_event(self.ctl, state["ev"], state["ev_thresh"],
                                                   env_ds, state["interp_y"], fade_p, disable)
            ctl = {}
        ctl.update(fshape_m=fsh.reshape(*lead, 4, 2), bank={"fused": bst}, bands=yb, env_m=env_m,
                   ev=ev, ev_thresh=evt, ics=ics, interp_y=iy, aux=aux)
        return ctl

    def _audio(self, state, x, ctl):
        """The delayed bands through the matrices, the allpasses and the sums
        (K12 + K13), the inverse fshape (K2, or K3 under float32), the
        output columns and the lookahead line's splice, from ctl (_control's
        result)."""
        lead, B = x.shape[:-2], x.shape[-2]  # lead: (S,) with a stream axis
        L = self.fb_buf_len
        yb = ctl["bands"]
        audio = m4.m4mb_audio_f32 if x.dtype == torch.float32 else m4.m4mb_audio
        sig, pf_m = audio(self.audio, yb.view(*lead, B, N_BANDS, 2), state["fb_buf"],
                          state["interp_c"], ctl["ics"], state["pf_m"])
        inv, sig = self._cascade("inv", state["inv_fshape_m"].transpose(-3, -2), sig)
        cols = []
        for k in range(self.istream.channels):
            cols.append(sig[..., 0] if k == self.cfg.c0 else sig[..., 1] if k == self.cfg.c1
                        else x[..., k])
        cols += [sig[..., j] - 1e-15 for j in range(2, self.audio.n_sig)]
        new_state = dict(
            state,
            **{k: v for k, v in ctl.items() if k not in ("bands", "ics", "aux")},
            # the last coefficient set (a copy only with a stream axis)
            interp_c=ctl["ics"][..., -1, :, :, :].contiguous(),
            fb_buf=splice(state["fb_buf"].view(*lead, L, 2 * N_BANDS), yb, L, L - B, B).view(
                *lead, L, N_BANDS, 2),
            pf_m=pf_m,
            inv_fshape_m=inv.transpose(-3, -2),
            fade_p=torch.tensor(max(int(state["fade_p"]) - B, 0), dtype=torch.int64),
        )
        if "aux" in state:
            new_state["aux"] = ctl["aux"]
        return new_state, torch.stack(cols, dim=-1)

    # --- chain hooks (mirror matrix4) ---

    def channel_deps(self):
        n_in, n_out = self.istream.channels, self.ostream.channels
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
        n_in, n_out = self.istream.channels, self.ostream.channels
        lat = np.zeros(n_out, dtype=np.int64)
        req = np.zeros(n_out, dtype=np.int64)
        # self.len = fb_buf_len + (phase_lin-1): the prepended FIR's group
        # delay plus the lookahead (matrix4_mb.c:781); the fir effect itself
        # reports no buffering latency, so the whole amount is carried here
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
        samples[self.cfg.c0] += self.fb_buf_len
        samples[self.cfg.c1] += self.fb_buf_len
        for i in range(self.istream.channels, self.ostream.channels):
            samples[i] += self.fb_buf_len

    def host_update(self, state):
        if self._signal_flag:
            self._signal_flag = False
            # toggled on the host: both leaves are CPU tensors
            state["disable"] = torch.logical_not(state["disable"])
            state["fade_p"] = torch.tensor(self.fade_frames - int(state["fade_p"]), dtype=torch.int64)
        if self.cfg.status_type != "none" and "aux" in state:
            from dsp_tpu_torch.cli import terminal

            aux = state["aux"][-1].to("cpu").numpy()  # the status lines' one device read
            if self._statuslines is None:
                self._statuslines = [terminal.Statusline() for _ in range(N_BANDS)]
                for sl in self._statuslines:
                    terminal.register(sl)
            for sl, text in zip(self._statuslines, self.status_text(aux, bool(state["disable"]))):
                sl.set(text)

    def status_text(self, aux, disabled):
        """The 13 status lines for one tick's aux [13, 2] (text or bars)."""
        off = " [off]" if disabled else ""
        lines = []
        for k in range(N_BANDS):
            lr, cs = aux[k, 0], aux[k, 1]
            if self.cfg.status_type == "text":
                lines.append(f"{self.name}{off}: band {k:2d}: lr: {np.degrees(lr):+06.2f}; "
                             f"cs: {np.degrees(cs):+06.2f}")
            else:
                lines.append(f"{self.name}{off}: band {k:2d}: L[{draw_steering_bar(lr)}]R; "
                             f"C[{draw_steering_bar(cs)}]S")
        return lines

    def host_finish(self, state):
        from dsp_tpu_torch.cli import terminal

        if self._statuslines:
            for sl in self._statuslines:
                terminal.unregister(sl)
            self._statuslines = None


def matrix4_mb_effect_init(ei, istream, selector, dir_, argv):
    mb = Matrix4MbEffect(argv[0], istream, selector, argv)
    fir = FirEffect(argv[0], istream, selector, mb.phase_lin_filter[:, None], 0, False)
    return [fir, mb]


register_effect(
    "matrix4_mb",
    "matrix4_mb [options ...] [surround_level][/surround_level_rear]",
    matrix4_mb_effect_init,
)
