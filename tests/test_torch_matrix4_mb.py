"""Slice F of dsp_tpu_torch against dsp_tpu, on the CPU in float64: the
parts of matrix4_mb (effects/matrix4_mb.py; K1 on its 13-band bank, K11 over
the bands, K9 + K10 with the cross-band threshold modulation, K12 + K13).

The port's wrappers run their plain versions here. matrix4_mb's engine is
chaotic where a band sits at crosstalk level (PARITY.md), so precision is
held by parts, each with the same inputs on both sides:
* host tables (filter bank, phase-linearising FIR, the bank's blocked plan,
  parameters, contour, fshape, initial state): equal.
* the bank on its 26 lanes: -280 dBFS (measured -315.8 to -319.1).
* the 13 coupled engines fed the same envelopes: every bool and integer
  leaf equal after every block, the thresholds bit for bit, the other
  floats within 1e-13 relative (measured 2.4e-15).
* the threshold modulation alone, inside dsp_tpu's own scan: bit for bit.
* the audio path under dsp_tpu's control: -290 dBFS (measured -292.5 to
  -293.3: the inverse fshape's 10 Hz shelf carries large states, and the
  packages' scans group its rounding differently).
The free-running chains, checkpoints and the display are in
test_torch_matrix4_mb_chain.py.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from test_torch_matrix4 import _rel, transient_signal
from torch_parity import FS, worst_dbfs


def _effects(opts, fs=FS):
    """(port, dsp_tpu) Matrix4MbEffect for `matrix4_mb <opts>`."""
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.matrix4_mb import Matrix4MbEffect as JMB
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.matrix4_mb import Matrix4MbEffect

    argv = ["matrix4_mb", *opts]
    sel = np.ones(2, dtype=bool)
    return (Matrix4MbEffect(argv[0], StreamInfo(fs, 2), sel, argv),
            JMB(argv[0], JStream(fs, 2), sel, argv))


def _tensors(tree):
    """numpy / jax state -> the same nesting with torch tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree
    return torch.as_tensor(np.array(tree))


# --- host tables -----------------------------------------------------------------


@pytest.mark.parametrize("ftype,stops", [
    ("elliptic", [35.0, 50.0]), ("elliptic", [55.0, 70.0]), ("butterworth", [0.0, 0.0]),
    ("chebyshev1", [25.0, 0.0]), ("chebyshev2", [30.0, 0.0]),
])
def test_filter_bank_equals_dsp_tpu(ftype, stops):
    from dsp_tpu.ops import cap5 as jc5
    from dsp_tpu_torch.ops import cap5 as c5

    for fs in (44100, 96000):
        caps, comp = c5.build_filter_bank(fs, ftype, stops)
        jcaps, jcomp = jc5.build_filter_bank(fs, ftype, stops)
        assert len(caps) == len(jcaps) == 12 and len(comp) == len(jcomp) == 25
        for a, b in zip(caps, jcaps):
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a)
        assert all(np.array_equal(a, b) for a, b in zip(comp, jcomp))
        bank, jbank = c5.NumpyBank(caps, comp), jc5.NumpyBank(jcaps, jcomp)
        for i in range(64):
            s = 1.0 if i == 0 else 0.0
            assert np.array_equal(bank.run_sample(s), jbank.run_sample(s))


TABLE_CASES = [
    (["-6"], 44100),
    (["filter_type=butterworth,freq_mask=0.5", "-6"], 44100),
    (["direct_path", "-3/0"], 48000),
    (["matrix=v1,shelf=-3:800:0.5,lowpass=8k,filter_type=chebyshev2:30", "-6"], 96000),
]


@pytest.mark.parametrize("opts,fs", TABLE_CASES, ids=[" ".join(o) + f" {fs}" for o, fs in TABLE_CASES])
def test_effect_tables_and_state_equal_dsp_tpu(opts, fs):
    """The per-band event parameters, thresholds, contour, fshape and its
    inverse, the phase-linearising FIR and every leaf of state_for_block,
    with the jax tree order and structure string."""
    import jax

    from dsp_tpu_torch.convert import flatten_states

    e, je = _effects(opts, fs)
    for name in ("ev_thresh_max", "ev_thresh_min", "contour", "fshape_c", "inv_fshape_c",
                 "phase_lin_filter"):
        assert np.array_equal(getattr(e, name), getattr(je, name)), name
    for name in ("g_ev_thresh", "g_env", "len", "fb_buf_len", "fade_frames", "pf_c1"):
        assert getattr(e, name) == getattr(je, name), name
    assert e.ev_params.keys() == je.ev_params.keys()
    for k, v in e.ev_params.items():
        if isinstance(v, dict):
            assert all(np.array_equal(v[kk], je.ev_params[k][kk]) for kk in v), k
        else:
            assert np.array_equal(v, je.ev_params[k]) and type(v) is type(je.ev_params[k]), k
    if fs == 44100 and opts == ["-6"]:
        assert len(e.phase_lin_filter) == 1306 and e.fb_buf_len == 2610 and e.len == 3915
    for B in (2048, 1056):
        st, jst = e.state_for_block(B), je.state_for_block(B)
        leaves, treedef = flatten_states(_tensors(st))
        assert treedef == str(jax.tree_util.tree_structure(jst))
        for a, b in zip(leaves, jax.tree_util.tree_leaves(jst)):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and a.shape == b.shape and np.array_equal(a.numpy(), b)
    assert st["fade_p"].dtype == torch.int64 and st["disable"].dtype == torch.bool
    assert tuple(np.shape(st["bank"]["fused"])) == (2, 26, 40) and np.shape(st["aux"]) == (33, 13, 2)


@pytest.mark.parametrize("B", [2048, 1056])
def test_bank_plan_equals_dsp_tpu(B):
    """The 13-band tree composed on the host into one blocked plan: C = 26,
    n = 40, L = 128 (or L = 1 for a block that is not a multiple of 128)."""
    e, je = _effects(["-6"])
    plan, jplan = e._bank_plan(B), je._bank_plan(B)
    assert (plan.C, plan.n, plan.L) == (jplan.C, jplan.n, jplan.L) == (26, 40, 128 if B == 2048 else 1)
    for k in ("W", "V", "P", "AL", "c0"):
        assert np.array_equal(getattr(plan, k), getattr(jplan, k)), k
    # the kernel's taps: W's first column below the diagonal
    assert np.array_equal(plan.h[:, : plan.L - 1], jplan.W[:, 1:, 0])


# --- the bank ----------------------------------------------------------------------


@pytest.mark.parametrize("B", [2048, 1056])
def test_bank_matches_dsp_tpu(B):
    """lti_blocked's plain version on the 26-lane bank against dsp_tpu's
    iir.lti_blocked over 3 blocks of transients (its L = 1 carry is a
    Kogge-Stone scan, the port's serial)."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu.ops import iir as jiir
    from dsp_tpu_torch.ops import iir

    e, je = _effects(["-6"])
    plan, jplan = e._bank_plan(B), je._bank_plan(B)
    x = np.tile(transient_signal(0.2, seed=9)[: 3 * B], (1, 13))
    st = torch.zeros((2, 26, plan.n), dtype=torch.float64)
    jst = jnp.zeros((2, 26, plan.n))
    run = jax.jit(lambda s, v: jiir.lti_blocked(jplan, s, v))
    worst = -math.inf
    for b in range(3):
        xb = x[b * B:(b + 1) * B]
        st, y = iir.lti_blocked_ref(plan, st, torch.as_tensor(xb))
        jst, jy = run(jst, jnp.asarray(xb))
        worst = max(worst, worst_dbfs(y.numpy(), jy), worst_dbfs(st[0].numpy(), np.asarray(jst).sum(0)))
    print(f"bank at B={B}: {worst:.1f} dBFS")
    assert worst <= -280.0


# --- the coupled engines --------------------------------------------------------------


def test_fma_ref_rounds_once():
    """fma_ref against exact rational arithmetic, on random operands and on
    products that cancel against the addend."""
    from dsp_tpu_torch.ops.m4_engine import fma_ref

    rng = np.random.default_rng(2)
    a = rng.standard_normal(3000) * np.exp(rng.uniform(-8, 8, 3000))
    b = rng.standard_normal(3000)
    c = np.concatenate([rng.standard_normal(1500) * np.exp(rng.uniform(-8, 8, 1500)),
                        -(a[1500:] * b[1500:]) * (1 + rng.uniform(-1e-12, 1e-12, 1500))])
    got = fma_ref(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)])
    assert np.array_equal(got, want)


def _control_probe(je, B):
    """dsp_tpu's own _control, jitted, with two spies: the envelopes the
    engines see can be given (dsp_tpu's env_ewma_scan is replaced while the
    function traces), and the interpolator's coefficient sets (what passes
    its optimization_barrier) come out. Returns run(state, x, envs) ->
    (ctl, vals, ics); envs None: dsp_tpu's own envelopes."""
    import jax

    from dsp_tpu.ops import m4_engine as jm4

    holder = {}
    scan, barrier = jm4.env_ewma_scan, jax.lax.optimization_barrier

    def given_scan(m0, m0_lo, g, env_in, df):
        envs = holder.get("envs")
        return scan(m0, m0_lo, g, env_in, df) if envs is None else (envs[-1], None, envs)

    def spy(t):
        holder["ics"] = t[0]
        return barrier(t)

    def trace(state, x, envs):
        holder["envs"] = envs
        ctl, vals, _ = je._control(state, x)
        return ctl, vals, holder.pop("ics")

    given, own = jax.jit(trace), jax.jit(lambda s, x: trace(s, x, None))

    def run(state, x, envs=None):
        jm4.env_ewma_scan, jax.lax.optimization_barrier = given_scan, spy
        try:
            return own(state, x) if envs is None else given(state, x, envs)
        finally:
            jm4.env_ewma_scan, jax.lax.optimization_barrier = scan, barrier
            holder.clear()

    return run


@pytest.fixture(scope="module")
def control_of():
    """control_of(opts, B) -> (port effect, dsp_tpu effect, its
    _control_probe run) for `matrix4_mb <opts>` at block B, made once a
    module: the engine and audio tests of one configuration share
    dsp_tpu's jitted control instead of compiling it each."""
    made = {}

    def get(opts, B):
        key = (tuple(opts), B)
        if key not in made:
            e, je = _effects(opts)
            made[key] = (e, je, _control_probe(je, B))
        return made[key]

    return get


ENGINE_CASES = [["-6"], ["matrix=v1", "-6"], ["direct_path", "-3/0"]]


@pytest.mark.parametrize("opts", ENGINE_CASES, ids=[" ".join(o) for o in ENGINE_CASES])
def test_coupled_engines_match_dsp_tpu(opts, control_of):
    """The 13 band engines with the threshold modulation: the port's
    m4mb_event_ref and dsp_tpu's own control scan fed the same envelopes
    and the same start state (dsp_tpu's, after 0.28 s of transients), each
    running on from its own result over 3 blocks. Every bool and integer
    leaf equal after every block, the thresholds bit for bit, the other
    floats, the coefficient sets and the display within 1e-13 relative;
    events sampled, were held and released."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu_torch.ops import m4_engine as m4

    B = 2048
    e, je, run = control_of(opts, B)
    step = jax.jit(je.step)
    x = transient_signal(0.5, seed=8)
    jst = jax.tree_util.tree_map(jnp.asarray, je.state_for_block(B))
    warm = 6
    for b in range(warm):
        jst, _ = step(jst, jnp.asarray(x[b * B:(b + 1) * B]))
    ev, evt, iy = (_tensors(jax.tree_util.tree_map(np.asarray, jst[k]))
                   for k in ("ev", "ev_thresh", "interp_y"))
    exact = {k for k, kind in m4.EV_LEAVES if kind != "f"}
    worst = 0.0
    for b in range(warm, warm + 3):
        xb = jnp.asarray(x[b * B:(b + 1) * B])
        bands = torch.as_tensor(np.asarray(run(jst, xb)[0]["bands"]))
        envs = m4.mb_envelopes_ref(bands, torch.as_tensor(np.asarray(jst["env_m"])), e.g_env,
                                   None if e.fmw is None else torch.as_tensor(e.fmw))
        ctl, _, ics_j = run(jst, xb, jnp.asarray(envs.numpy()))
        ev, evt, ics, iy, aux = m4.m4mb_event_ref(e.ctl, ev, evt, envs[31::32], iy,
                                                  int(jst["fade_p"]), bool(jst["disable"]))
        for k, v in ctl["ev_new"].items():
            if k in exact:
                assert np.array_equal(ev[k].numpy(), np.asarray(v)), (b, k)
            else:
                worst = max(worst, _rel(ev[k].numpy(), v))
        assert np.array_equal(evt.numpy(), np.asarray(ctl["evt_new"])), b
        for got, want in ((ics, ics_j), (iy, ctl["iy_new"]), (aux, ctl["auxs"])):
            worst = max(worst, _rel(got.numpy(), want))
        jst = dict(jst, ev=ctl["ev_new"], ev_thresh=ctl["evt_new"], interp_y=ctl["iy_new"],
                   env_m=jnp.asarray(envs[-1].numpy()))
    counts = {k: int(ev[k].sum()) for k in ("ord_count", "diff_count", "early_count")}
    print(f"engines {opts}: floats within {worst:.2e} relative; {counts}")
    assert worst <= 1e-13
    assert counts["diff_count"] + counts["ord_count"] >= 13 and counts["early_count"] > 0
    assert (evt.numpy() < e.ev_thresh_max).any()  # the modulation moved some threshold


def test_threshold_modulation_is_dsp_tpus_bit_for_bit():
    """mb_threshold_ref against dsp_tpu's own _control at one tick a call
    (B = 32), over random engine states chosen so that many bands are
    candidates and their steering alike: equal bit for bit. The same
    states through versions that drop one of the three fused multiply-adds
    (the similarity's, the target's, the EWMA's), or sum `fact` with
    torch.sum, differ: dsp_tpu's XLA:CPU takes those FMAs and sums left to
    right (inside the 64-tick scan of a block too:
    test_coupled_engines_match_dsp_tpu)."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu_torch.ops import m4_engine as m4

    e, je = _effects(["-6"])
    run = _control_probe(je, 32)
    rng = np.random.default_rng(4)
    base = jax.tree_util.tree_map(np.asarray, je.state_for_block(32))
    x = jnp.zeros((32, 2))
    _, etmax, etmin, _ = e.ctl.tensors("cpu")

    def plain_fma(a, b, c):
        return torch.as_tensor(a, dtype=torch.float64) * b + c

    def left_to_right(t):
        acc = t[:, 0]
        for j in range(1, 13):
            acc = acc + t[:, j]
        return acc

    def variant(ev, evt, f_sim=m4.fma_ref, f_tgt=m4.fma_ref, f_ewma=m4.fma_ref, total=left_to_right):
        sl, la, d = ev["slope_last"], ev["last"], ev["diff_last"]
        cand = ((sl[:, 0] > 0.0) & (la[:, 0] > etmin)) | ((sl[:, 1] > 0.0) & (la[:, 1] > etmin))
        dm = torch.maximum((d[:, None, 0] - d[None, :, 0]).abs(), (d[:, None, 1] - d[None, :, 1]).abs())
        sim = m4.smoothstep(f_sim(-dm, float(16.0 / np.pi), 1.0))
        fact = torch.where(cand, total(sim * cand[None, :].double()) - 1.0, 0.0)
        target = f_tgt(-((etmax - etmin) * fact), 1.0 / 12, etmax)
        return torch.where(target >= evt, f_ewma(e.ctl.g_evt, target - evt, evt), target)

    drops = {"similarity": {"f_sim": plain_fma}, "target": {"f_tgt": plain_fma},
             "EWMA": {"f_ewma": plain_fma}, "torch.sum": {"total": lambda t: t.sum(1)}}
    differ = dict.fromkeys(drops, 0)
    for _ in range(48):
        ev = dict(base["ev"])
        ev["last"] = rng.uniform(0.5, 1.3, (13, 2)) * e.ev_thresh_max[:, None]
        ev["slope_last"] = rng.uniform(-0.2, 1.0, (13, 2))
        ev["diff_last"] = rng.uniform(-0.1, 0.1, (13, 2)) + rng.uniform(-0.2, 0.2)
        evt0 = rng.uniform(e.ev_thresh_min, e.ev_thresh_max)
        ctl, _, _ = run(jax.tree_util.tree_map(jnp.asarray, dict(base, ev=ev, ev_thresh=evt0)), x)
        want = np.asarray(ctl["evt_new"])
        tev, tevt = _tensors(ev), torch.as_tensor(evt0)
        assert np.array_equal(m4.mb_threshold_ref(e.ctl, tev, tevt).numpy(), want)
        assert np.array_equal(variant(tev, tevt).numpy(), want)
        for name, kw in drops.items():
            differ[name] += int((variant(tev, tevt, **kw).numpy() != want).sum())
    print(f"of 624 thresholds, differ without each: {differ}")
    assert all(n > 0 for n in differ.values()), differ


def test_band_mix_matches_dsp_tpu():
    """The frequency-mask mix (an einsum in dsp_tpu) against the port's
    sum from band 0 up, on a block of bands: within 1e-15 relative."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu_torch.ops import m4_engine as m4

    e, _ = _effects(["freq_mask=0.5", "-6"])
    rng = np.random.default_rng(6)
    bands = rng.standard_normal((2048, 13, 2)) * np.exp(rng.uniform(-6, 0, (1, 13, 1)))
    want = jax.jit(lambda b: jnp.einsum("kj,bjc->bkc", jnp.asarray(e.fmw), b))(jnp.asarray(bands))
    got = m4.band_mix_ref(torch.as_tensor(bands), torch.as_tensor(e.fmw))
    assert _rel(got.numpy(), want) <= 1e-15


# --- the audio path ----------------------------------------------------------------


AUDIO_CASES = [["-6"], ["direct_path", "-3/0"], ["phase_flip=false", "-6"]]


@pytest.mark.parametrize("opts", AUDIO_CASES, ids=[" ".join(o) for o in AUDIO_CASES])
def test_audio_path_under_dsp_tpus_control(opts, control_of):
    """dsp_tpu's _control output (its bands and its coefficient sets) through
    both audio paths: the port's _audio (m4mb_audio's plain version, the
    inverse fshape on K2's, the output columns) against dsp_tpu's _audio,
    over 4 blocks, each side carrying its own audio state."""
    import jax
    import jax.numpy as jnp

    B = 2048
    e, je, run = control_of(opts, B)
    audio = jax.jit(je._audio)
    x = transient_signal(0.5, seed=10)
    jst = jax.tree_util.tree_map(jnp.asarray, je.state_for_block(B))
    st = _tensors(e.state_for_block(B))
    worst = -math.inf
    for b in range(4):
        xb = x[b * B:(b + 1) * B]
        ctl, vals, ics = run(jst, jnp.asarray(xb))
        jst, jy = audio(jst, jnp.asarray(xb), vals, ctl)
        tctl = {k: _tensors(np.asarray(v)) for k, v in (
            ("bands", ctl["bands"].reshape(B, 26)), ("ics", ics), ("env_m", ctl["env_m"]),
            ("ev_thresh", ctl["evt_new"]), ("interp_y", ctl["iy_new"]), ("aux", ctl["auxs"]),
            ("fshape_m", ctl["fsh_new"].reshape(4, 2)))}
        tctl["ev"] = _tensors(jax.tree_util.tree_map(np.asarray, ctl["ev_new"]))
        tctl["bank"] = {"fused": _tensors(np.asarray(ctl["bst"]["fused"]))}
        st, y = e._audio(st, torch.as_tensor(xb), tctl)
        worst = max(worst, worst_dbfs(y.numpy(), jy))
        for k in ("pf_m", "fb_buf", "interp_c"):
            assert worst_dbfs(st[k].numpy(), jst[k]) <= -290.0, k
    print(f"audio {opts}: {worst:.1f} dBFS")
    assert worst <= -290.0
