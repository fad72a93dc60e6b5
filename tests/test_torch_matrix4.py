"""Slice E of dsp_tpu_torch against dsp_tpu, on the CPU in float64: the
matrix4 engine (K9-K11, ops/m4_engine.py) and the matrix4 effect (K12, K13).

The port's wrappers run their plain versions here. The engine's decisions
(its bool and integer leaves: sample, hold, the tick stamps, the event
counters) are held equal, tick by tick and at the end of every chain; the
inputs are program material with transients, so that events sample, hold
and release, and the tests assert that they did. Floats differ by rounding
only: torch's and XLA's atan/tan/sin/cos/exp and FMA contraction, the
scans' grouping. Tolerances and why:
* parameters, initial states, configs: equal (the same host code).
* event_step tick by tick, the matrix coefficients on a grid of branch
  edges, the scans: 1e-12 relative (measured 1e-15 to 1e-13).
* chains: each limit pinned about 30 dB above its measurement (1 s of
  transients, block 2048 unless named).
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import FS, jax_chain, port_chain, worst_dbfs

REPO = Path(__file__).resolve().parents[1]
DECISIONS = ("ord_count", "diff_count", "early_count", "ignore_count", "t", "t_hold",
             "t_sample", "buf_p")


def transient_signal(seconds, fs=FS, seed=5, channels=2):
    """Program material with transients (chip_smoke.py's): a quiet stereo
    bed and decaying noise bursts, one every 0.15-0.45 s, each panned left,
    right, centre, to the rear (antiphase) or between. A third channel, if
    asked for, carries its own noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    t = np.arange(n) / fs
    x = 0.02 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)], 1)
    x += 0.005 * rng.standard_normal((n, 2))
    pans = np.array([[1.0, 0.05], [0.05, 1.0], [0.7, 0.7], [0.7, -0.7], [1.0, 0.5], [-0.3, 1.0]])
    pos = int(0.1 * fs)
    while pos < n:
        m = min(n - pos, int(0.3 * fs))
        burst = rng.standard_normal(m) * np.exp(-np.arange(m) / (0.04 * fs)) * 0.3
        x[pos:pos + m] += burst[:, None] * pans[rng.integers(len(pans))]
        pos += int(rng.uniform(0.15, 0.45) * fs)
    if channels == 3:
        x = np.concatenate([x[:, :1], 0.1 * rng.standard_normal((n, 1)), x[:, 1:]], axis=1)
    return x


def _rel(a, b):
    """max |a - b| over max(1, max |b|); NaN where one has NaN and the other
    not (both packages give NaN at the same grid points, e.g. a square root
    of a rounding-negative difference)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return math.nan
    a, b = np.nan_to_num(a), np.nan_to_num(b)
    return float(np.abs(a - b).max(initial=0.0)) / max(1.0, float(np.abs(b).max(initial=0.0)))


# --- the config parser -------------------------------------------------------

OPTIONS = [
    [], ["-6"], ["-6/-3"], ["/-3"], ["status=text"], ["status"], ["status=none"],
    ["matrix=v1"], ["matrix=v2"], ["matrix=v3"], ["matrix=v4:0.3"], ["shelf=-3:800:0.5"],
    ["shelf=none"], ["lowpass=none"], ["lowpass=8k"], ["contour_pwrcmp=0.5"],
    ["phase_flip=false", "-6"], ["phase_flip,signal,direct_path"], ["rear_event_mask=0.5"],
    ["surround_delay=20m"], ["lookahead=1.2"], ["dpwr_decouple=f"], ["filter_type=chebyshev1"],
    ["filter_type=elliptic:40:60"], ["filter_type=chebyshev2:30", "freq_mask=0.5"],
    # errors
    ["matrix=v9"], ["matrix=v4:2"], ["status=loud"], ["shelf=abc"], ["shelf=-3:50"],
    ["lowpass=30k"], ["bogus"], ["-6", "matrix=v1"], ["/x"], ["contour_pwrcmp=2"],
    ["phase_flip=maybe"], ["filter_type=kaiser"], ["filter_type=chebyshev1:5"],
    ["filter_type=elliptic:10"], ["freq_mask=3"], ["lookahead=5"], ["surround_delay="],
]


@pytest.mark.parametrize("is_mb", [False, True])
@pytest.mark.parametrize("opts", OPTIONS, ids=[" ".join(o) or "none" for o in OPTIONS])
def test_config_init_equals_dsp_tpu(opts, is_mb):
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.base import EffectError as JErr
    from dsp_tpu.effects.matrix4 import matrix4_config_init as jinit
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects import EffectError
    from dsp_tpu_torch.effects.matrix4 import matrix4_config_init

    argv = ["matrix4_mb" if is_mb else "matrix4", *opts]
    sel = np.array([True, False, True])
    try:
        want = vars(jinit(argv[0], JStream(48000, 3), sel, argv, is_mb))
    except JErr as e:
        with pytest.raises(EffectError) as got:
            matrix4_config_init(argv[0], StreamInfo(48000, 3), sel, argv, is_mb)
        assert str(got.value) == str(e)
        return
    assert vars(matrix4_config_init(argv[0], StreamInfo(48000, 3), sel, argv, is_mb)) == want


@pytest.mark.parametrize("fs,sel", [(22050, [True, True]), (44100, [True, False])])
def test_config_init_stream_errors_equal_dsp_tpu(fs, sel):
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.base import EffectError as JErr
    from dsp_tpu.effects.matrix4 import matrix4_config_init as jinit
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects import EffectError
    from dsp_tpu_torch.effects.matrix4 import matrix4_config_init

    with pytest.raises(JErr) as e:
        jinit("matrix4", JStream(fs, 2), np.array(sel), ["matrix4"], False)
    with pytest.raises(EffectError, match=str(e.value)):
        matrix4_config_init("matrix4", StreamInfo(fs, 2), np.array(sel), ["matrix4"], False)


# --- parameters and state ----------------------------------------------------


@pytest.mark.parametrize("fs", [44100, 48000, 96000, 192000])
def test_event_params_and_state_equal_dsp_tpu(fs):
    from dsp_tpu.ops import m4_engine as jm4
    from dsp_tpu_torch.ops import m4_engine as m4

    p, jp = m4.make_event_params(fs / 32), jm4.make_event_params(fs / 32)
    assert p.keys() == jp.keys()
    for k in p:
        if isinstance(p[k], dict):
            assert p[k] == jp[k], k
        else:
            assert np.array_equal(p[k], jp[k]) and type(p[k]) is type(jp[k]), k
    for make in ("make_event_state", "make_event_state_lo"):
        st, jst = getattr(m4, make)(p), getattr(jm4, make)(jp)
        assert st.keys() == jst.keys()
        for k in st:
            a, b = np.asarray(st[k]), np.asarray(jst[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), (make, k)
    assert len(m4.EV_LEAVES) == len({k for k, _ in m4.EV_LEAVES}) == len(m4.make_event_state(p))
    for k, kind in m4.EV_LEAVES:  # the kernel's leaf order and kinds
        assert np.asarray(m4.make_event_state(p)[k]).dtype.kind == kind, k


def _envelopes(fs, seconds, seed):
    """The envelope stream matrix4 feeds its engine: the band-limited pair's
    eight EWMAs at the ticks, through the port's plain versions."""
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.matrix4 import Matrix4Effect
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    e = Matrix4Effect("matrix4", StreamInfo(fs, 2), np.ones(2, dtype=bool), ["matrix4"])
    x = torch.as_tensor(transient_signal(seconds, fs, seed))
    B = len(x) // 32 * 32
    t = torch.as_tensor
    zero = torch.zeros(2, 2, dtype=torch.float64)
    _, y = iir.biquad_scan_ref(t(e.A_hp), t(e.B_hp), t(e.c0_hp), zero, x[:B])
    _, y = iir.biquad_scan_ref(t(e.A_lp), t(e.B_lp), t(e.c0_lp), zero, y)
    return e, m4.m4_env_ref(y, torch.zeros(8, dtype=torch.float64), e.g_env)[1]


def test_event_step_tick_by_tick_matches_dsp_tpu():
    """The port's event_step over a lane axis of three streams, against
    dsp_tpu's event_step run on each stream alone, tick by tick: every
    decision leaf equal at every tick, the outputs within 1e-12 relative at
    every tick and the float leaves at every eighth."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu.ops import m4_engine as jm4
    from dsp_tpu_torch.ops import m4_engine as m4

    streams = [_envelopes(FS, 0.5, seed)[1] for seed in (5, 6, 7)]
    e = _envelopes(FS, 0.01, 5)[0]
    p = m4.host_params(e.ev_params)
    jp = jm4.cast_params(jm4.make_event_params(FS / 32), jnp.float64)

    @jax.jit
    def jstep(st, e8):
        env = {"l": e8[0], "r": e8[1], "sum": e8[2], "diff": e8[3]}
        pwr = {"l": e8[4], "r": e8[5], "sum": e8[6], "diff": e8[7]}
        return jm4.event_step(jp, st, env, pwr, 1.0)

    st0 = jm4.make_event_state(jm4.make_event_params(FS / 32))
    jst = [jax.tree_util.tree_map(jnp.asarray, st0) for _ in streams]
    st = {k: torch.as_tensor(np.stack([np.asarray(v)] * 3)) for k, v in st0.items()}
    exact = {k for k, kind in m4.EV_LEAVES if kind != "f"}
    worst = 0.0
    for i in range(min(len(s) for s in streams)):
        e8 = torch.stack([s[i] for s in streams])  # [3, 8]
        st, out = m4.event_step(p, st, {k: e8[:, j] for j, k in enumerate(("l", "r", "sum", "diff"))},
                                {k: e8[:, 4 + j] for j, k in enumerate(("l", "r", "sum", "diff"))})
        for s, j in enumerate(jst):
            jst[s], jout = jstep(j, jnp.asarray(streams[s][i].numpy()))
            for k, v in jst[s].items():
                if k in exact:
                    assert np.array_equal(st[k][s].numpy(), np.asarray(v)), (i, s, k)
                elif i % 8 == 0:
                    worst = max(worst, _rel(st[k][s].numpy(), v))
            for k in ("ax_lr", "ax_cs", "ax_ev_lr", "ax_ev_cs", "ax_dpwr_lr", "ax_dpwr_cs",
                      "pwrcmp_factor"):
                worst = max(worst, _rel(out[k][s].numpy(), jout[k]))
    events = int(st["diff_count"].sum() + st["ord_count"].sum())
    assert events >= 3 and int(st["early_count"].sum()) > 0
    assert worst <= 1e-12


def _grid():
    q = math.pi / 4
    v = [0.0, q / 2, -q / 2, q, -q, 0.3, -0.3, 0.05, -0.05, q / 2 + 1e-9, -q / 2 - 1e-9, 0.6]
    lr, cs = np.meshgrid(v, v)
    lr, cs = lr.ravel(), cs.ravel()
    border = np.linspace(-q, q, 9)  # |lr| + |cs| = pi/4, the `inside` border
    lr = np.concatenate([lr, border, border])
    cs = np.concatenate([cs, q - np.abs(border), -(q - np.abs(border))])
    return lr, cs


@pytest.mark.parametrize("version", ["v1", "v4"])
def test_matrix_coefs_match_dsp_tpu_on_branch_edges(version):
    import jax.numpy as jnp

    from dsp_tpu.ops import m4_engine as jm4
    from dsp_tpu_torch.ops import m4_engine as m4

    lr, cs = _grid()
    rng = np.random.default_rng(3)
    dp_lr, dp_cs = np.concatenate([lr[::-1], lr]), np.concatenate([cs, cs[::-1]])
    lr, cs = np.concatenate([lr, lr]), np.concatenate([cs, cs])
    sm = rng.uniform(0.3, 1.0, len(lr))
    args = (lr, cs, dp_lr, dp_cs, sm, np.minimum(sm * 1.5, 1.2))
    shelf = [sm * 0.8, sm * 0.6]
    fn = getattr(m4, f"calc_matrix_coefs_{version}")
    jfn = getattr(jm4, f"calc_matrix_coefs_{version}")
    m, rets = fn(*(torch.as_tensor(a) for a in args), 0.5, [torch.as_tensor(a) for a in shelf])
    jmm, jrets = jfn(*(jnp.asarray(a) for a in args), 0.5, [jnp.asarray(a) for a in shelf])
    for k in m:
        assert _rel(m[k].numpy(), jmm[k]) <= 1e-12, k
    for (f, s), (jf, js) in zip(rets, jrets):
        assert _rel(f.numpy(), jf) <= 1e-12 and _rel(s.numpy(), js) <= 1e-12
    t = (torch.as_tensor(lr), torch.as_tensor(cs))
    j = (jnp.asarray(lr), jnp.asarray(cs))
    assert _rel(m4.phase_flip_pos_rs(*t).numpy(), jm4.phase_flip_pos_rs(*j)) == 0.0
    pos = m4.phase_flip_pos_rs(*t)
    assert _rel(m4.phase_flip_ap1_c0(0.667829372575655, -7.6, pos).numpy(),
                jm4.phase_flip_ap1_c0(0.667829372575655, -7.6, jnp.asarray(pos.numpy()))) <= 1e-12
    for a, b in zip(m4.surr_direct_pan(*t), jm4.surr_direct_pan(*j)):
        assert _rel(a.numpy(), b) <= 1e-12


def test_scans_match_dsp_tpu():
    """The envelope EWMAs, the dynamic shelf and the ap1 allpass against
    dsp_tpu's associative scans, on a block of transients."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.matrix4 import Matrix4Effect as JM4
    from dsp_tpu.ops import m4_engine as jm4
    from dsp_tpu_torch.ops import m4_engine as m4

    rng = np.random.default_rng(4)
    x = transient_signal(0.2)[2048:4096]
    e = _envelopes(FS, 0.01, 5)[0]
    je = JM4("matrix4", JStream(FS, 2), np.ones(2, dtype=bool), ["matrix4"])
    m0 = rng.uniform(0, 0.1, 8)
    env_t = m4.m4_env_ref(torch.as_tensor(x), torch.as_tensor(m0), e.g_env)
    sum_, diff = x[:, 0] + x[:, 1], x[:, 0] - x[:, 1]
    env_in = np.stack([np.abs(x[:, 0]), np.abs(x[:, 1]), np.abs(sum_), np.abs(diff),
                       x[:, 0] ** 2, x[:, 1] ** 2, sum_ ** 2, diff ** 2], 1)
    last, _, envs = jax.jit(lambda m, v: jm4.env_ewma_scan(m, None, e.g_env, v, False))(
        jnp.asarray(m0), jnp.asarray(env_in))
    assert _rel(env_t[0].numpy(), last) <= 1e-12
    assert _rel(env_t[1].numpy(), np.asarray(envs)[31::32]) <= 1e-12
    sig = rng.standard_normal((2048, 4)) * 0.3
    g = rng.uniform(0.2, 1.0, (2048, 4))
    sm0 = rng.standard_normal(4) * 0.1
    for pr in (e.shelf, e.lowpass):
        mt, rt = m4._dyn_shelf_ref(pr, torch.as_tensor(sm0), torch.as_tensor(sig), torch.as_tensor(g))
        mj, rj = jax.jit(lambda *a: je._dyn_shelf_block(pr, *a))(
            jnp.asarray(sm0), jnp.asarray(sig), jnp.asarray(g))
        assert _rel(mt.numpy(), mj) <= 1e-12 and _rel(rt.numpy(), rj) <= 1e-12
    c0s = rng.uniform(-0.99, 0.0, (2048, 2))
    st = rng.standard_normal((2, 2)) * 0.1
    st_t, r_t = m4._ap1_ref(torch.as_tensor(st), torch.as_tensor(sig[:, :2]), torch.as_tensor(c0s))
    ap1 = jax.jit(je._ap1_block)
    for k in range(2):
        st_j, r_j = ap1(jnp.asarray(st[k]), jnp.asarray(sig[:, k]), jnp.asarray(c0s[:, k]))
        assert _rel(st_t[k].numpy(), st_j) <= 1e-12 and _rel(r_t[:, k].numpy(), r_j) <= 1e-12


# --- chains ----------------------------------------------------------------------

# (chain, channels, block, limit in dBFS): each limit about 30 dB above its
# measurement on 0.6 s of transients (-289.6 to -298.3 dBFS)
CHAINS = [
    ("matrix4 -6", 2, 2048, -265.0),
    ("matrix4 direct_path -6", 2, 2048, -265.0),
    ("matrix4 matrix=v1 -6", 2, 2048, -265.0),
    ("matrix4 phase_flip=false,shelf=none,lowpass=none -6", 2, 2048, -260.0),
    (":0,2 matrix4 -6", 3, 1000, -265.0),
    ("resample 48k matrix4 -6", 2, 2048, -100.0),
]
# After a resampler the engine's first half second is another matter. The
# steering axes are ratios of envelopes, and the envelopes start from zero:
# over the resampler's pre-ringing at the stream's start, the two packages'
# resampled signals (-308 dBFS apart, torch's and XLA's FFTs) differ in
# their low-order digits, and the slow EWMAs carry that for ~0.5 s (-131
# dBFS in the first 0.3 s, measured; both matrix4s given the same resampled
# input agree to -306 dBFS). From 0.6 s on the chain is held to -230 dBFS
# (measured -260.6).
SETTLED = {"resample 48k matrix4 -6": (0.6, -230.0)}


def _ev(cc):
    return next(st["ev"] for st in cc.states if isinstance(st, dict) and "ev" in st)


@pytest.mark.parametrize("spec,channels,block,limit", CHAINS, ids=[c[0] for c in CHAINS])
def test_chain_matches_dsp_tpu(spec, channels, block, limit):
    from dsp_tpu_torch.chain.chain import expected_out_frames

    seconds = SETTLED[spec][0] + 0.4 if spec in SETTLED else 0.6
    x = transient_signal(seconds, channels=channels)[:-123]
    t = port_chain(spec, block, channels)
    j = jax_chain(spec, block, channels)
    assert t.block_frames == j.block_frames
    y_t = t.process_array(x)
    y_j = np.asarray(j.process_array(x))
    assert y_t.shape == y_j.shape
    assert len(y_t) == expected_out_frames(t.chain, len(x)) - t.chain.output_discard
    ev_t, ev_j = _ev(t), _ev(j)
    for k in DECISIONS:
        assert int(ev_t[k]) == int(ev_j[k]), k
    assert int(ev_t["diff_count"]) + int(ev_t["ord_count"]) > 0
    assert int(ev_t["early_count"]) > 0
    assert worst_dbfs(y_t, y_j) <= limit
    if spec in SETTLED:
        start, settled = SETTLED[spec]
        n0 = int(start * t.chain.ostream.fs)
        assert worst_dbfs(y_t[n0:], y_j[n0:]) <= settled


def test_resampled_input_through_both_matrix4s():
    """Given the same resampled signal, the two packages' matrix4 agree from
    the first frame (the onset above is the resampler's rounding, carried
    by the engine, not a difference of the engines)."""
    from dsp_tpu.chain import CompiledChain as JCC
    from dsp_tpu.chain import build_chain_from_string as jbuild
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    x = transient_signal(0.4)
    r = port_chain("resample 48k", 2048).process_array(x, discard=False)
    y_t = CompiledChain(build_chain_from_string("matrix4 -6", StreamInfo(48000, 2)), 2560,
                        device="cpu").process_array(r)
    y_j = np.asarray(JCC(jbuild("matrix4 -6", JStream(48000, 2)), 2560).process_array(r))
    assert worst_dbfs(y_t, y_j) <= -270.0


def test_checkpoint_from_dsp_tpu_continues_in_the_port(tmp_path):
    """A matrix4 checkpoint saved by dsp_tpu mid-stream (events in flight)
    loads into the port with its bool and int64 leaves as they were, and the
    port's continuation matches dsp_tpu's uninterrupted run."""
    from dsp_tpu_torch.convert import flatten_states

    spec, block = "matrix4 -6", 2048
    x = transient_signal(0.6)
    half = 7 * block
    whole = np.asarray(jax_chain(spec, block).process_array(x, discard=False))
    j = jax_chain(spec, block)
    y1 = np.asarray(j.process_array(x[:half], drain=False, discard=False))
    j.save_state(str(tmp_path / "s.npz"))
    t = port_chain(spec, block)
    t.load_state(str(tmp_path / "s.npz"))
    leaves, _ = flatten_states(t.states)
    with np.load(tmp_path / "s.npz") as z:
        for i, leaf in enumerate(leaves):
            a = z[f"leaf_{i}"]
            assert str(leaf.dtype).removeprefix("torch.") == str(a.dtype)
            assert np.array_equal(leaf.cpu().numpy(), a)
    st = t.states[0]
    assert st["fade_p"].device.type == "cpu" and st["disable"].dtype == torch.bool
    assert st["ev"]["hold"].dtype == torch.bool and st["ev"]["t"].dtype == torch.int64
    y2 = t.process_array(x[half:], discard=False)
    y = np.concatenate([y1, y2])
    assert y.shape == whole.shape
    assert worst_dbfs(y, whole) <= -250.0


def test_status_strings_equal_dsp_tpu():
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects import matrix4 as jmod
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects import matrix4 as mod

    rng = np.random.default_rng(1)
    for a in [0.0, math.pi / 4, -math.pi / 4, 0.1, -0.33, 1.0, -2.0]:
        for ev in (False, True):
            assert mod.draw_steering_bar(a, ev) == jmod.draw_steering_bar(a, ev)
    for kind in ("text", "bars"):
        e = mod.Matrix4Effect("matrix4", StreamInfo(FS, 2), np.ones(2, dtype=bool),
                              ["matrix4", f"status={kind}"])
        je = jmod.Matrix4Effect("matrix4", JStream(FS, 2), np.ones(2, dtype=bool),
                                ["matrix4", f"status={kind}"])
        for disabled in (False, True):
            aux = rng.uniform(-0.8, 0.8, (64, 4))
            st = e.state_for_block(2048)
            st["aux"], st["disable"] = torch.as_tensor(aux), torch.tensor(disabled)
            e.host_update(st)
            jst = dict(je.state_for_block(2048), aux=aux, disable=np.bool_(disabled))
            je.host_update(jst)
            assert e._statusline.text == je._statusline.text
            e.host_finish(st)
            je.host_finish(jst)


def test_signal_toggle_needs_no_device_read(monkeypatch):
    """With `signal`, the toggle flips disable and restarts the fade on the
    host: both leaves are CPU tensors, and the values equal dsp_tpu's."""
    import jax.numpy as jnp

    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.matrix4 import Matrix4Effect as JM4
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.matrix4 import Matrix4Effect

    e = Matrix4Effect("matrix4", StreamInfo(FS, 2), np.ones(2, dtype=bool), ["matrix4", "signal"])
    je = JM4("matrix4", JStream(FS, 2), np.ones(2, dtype=bool), ["matrix4", "signal"])
    st = e.state_for_block(2048)
    jst = {"fade_p": jnp.asarray(3000, jnp.int64), "disable": jnp.asarray(False)}
    st["fade_p"] = torch.tensor(3000, dtype=torch.int64)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda *a, **k: pytest.fail("device copy"))
    for _ in range(3):
        e.signal()
        je.signal()
        e.host_update(st)
        je.host_update(jst)
        assert st["fade_p"].device.type == "cpu" and st["disable"].device.type == "cpu"
        assert int(st["fade_p"]) == int(jst["fade_p"]) and bool(st["disable"]) == bool(jst["disable"])
    e.host_update(st)  # no signal: nothing changes
    assert int(st["fade_p"]) == int(jst["fade_p"])
    off = Matrix4Effect("matrix4", StreamInfo(FS, 2), np.ones(2, dtype=bool), ["matrix4"])
    st2 = off.state_for_block(2048)
    off.signal()
    off.host_update(st2)  # without the option the reference ignores the signal
    assert not bool(st2["disable"]) and int(st2["fade_p"]) == 0


def test_bench_golden_first_second():
    """bench_goldens/matrix4.npz (dsp_tpu f64, `matrix4 -6` at block 65536),
    its first second. The raw output (no discard) to frame n depends on the
    input to frame n alone, and the engine's arithmetic does not depend on
    the block size, so the port renders the first 22 blocks of 2048."""
    from test_torch_resample import program_signal, render_raw

    z = np.load(REPO / "bench_goldens" / "matrix4.npz")
    want = z["hi"].astype(np.float64) + z["lo"].astype(np.float64)
    cc = port_chain("matrix4 -6", 2048)
    got = render_raw(cc, program_signal()[: 22 * 2048], 1.0)
    assert got.shape == (44100, 4)
    assert worst_dbfs(got, want[:44100]) <= -250.0
