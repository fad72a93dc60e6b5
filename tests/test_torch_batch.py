"""Batched processing on the CPU (CompiledChain.process_batch) and the stream
axis of the kernels it runs:

* process_batch over S streams against dsp_tpu's process_batch (float64)
  and against the port's own process_array a stream at a time, on
  tests/test_state_hygiene.py's chains (gain/eq/crossfeed, a 300-tap fir on
  the FDL engine, resample to 88.2 kHz);
* a chain with noise, which process_batch once refused, accepted: each
  stream equal to process_array of that stream from the live key;
* every kernel on the split-safe effects' path, through its plain version
  (what a CPU tensor runs): S = 3 streams in one call equal three
  one-stream calls, bit for bit, since each plain version runs a stream at
  a time. K1 (float64, float32, the (hi, lo) output), crossfeed's step,
  the run of biquads in its four forms, the lone K2/K3 (biquad_scan,
  biquad_scan_f32, biquad_scan_pair, biquad_scan_df with both state
  forms), the FFT wrappers (rfft_pack with its kept rows, fdl_mac,
  irfft_crop with an addend, splice), the three engines' steps (Nupols
  across a super-block, firing mid-way) in both dtypes, and the
  resampler's step on both routes in both dtypes.
"""

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import FLAGSHIP, FS, jax_chain, port_chain, stereo_signal, worst_dbfs
from dsp_tpu_torch.ops import fft_conv as fc
from dsp_tpu_torch.ops import iir
from dsp_tpu_torch.ops import resample_ops as ro

S = 3

FIR_300 = "fir coefs:" + ",".join(f"{v:.6f}" for v in np.sin(np.arange(300) * 0.7) * 0.05)
CHAINS = {
    "gain_eq_crossfeed": "gain -3 eq 1k 1.0 +3 crossfeed 700 4.5",
    "fir_fdl": FIR_300,
    "resample_2x": "resample 88.2k",
}
# dsp_tpu and the port compute the same float64 step with sums in another
# order. Measured, batch against dsp_tpu's batch: gain/eq/crossfeed -313.1,
# fir_fdl -307.1, resample_2x -302.5 dBFS; -275 keeps about 30 dB of margin
# over the worst
BATCH_LIMIT_DBFS = -275.0


@pytest.fixture(scope="module")
def streams():
    rng = np.random.default_rng(0)
    return rng.standard_normal((S, 5000, 2)) * 0.3


@pytest.mark.parametrize("name", list(CHAINS))
def test_batch_matches_dsp_tpu_and_per_stream(name, streams):
    spec = CHAINS[name]
    cc = port_chain(spec, 2048)
    batch = cc.process_batch(streams)
    ref = jax_chain(spec, 2048).process_batch(streams)
    assert batch.shape == ref.shape
    assert worst_dbfs(batch, ref) <= BATCH_LIMIT_DBFS, worst_dbfs(batch, ref)
    for s in range(S):
        cc.reset()
        one = cc.process_array(streams[s])
        np.testing.assert_array_equal(batch[s], one)


def test_batch_starts_from_the_live_state_and_leaves_it(streams):
    """A batch starts every stream from the chain's live state and does not
    advance it."""
    cc = port_chain(FLAGSHIP, 2048)
    cc.process_array(streams[0], drain=False)  # moves the live state on
    live = [t.clone() if isinstance(t, torch.Tensor) else t for t in cc.states]
    batch = cc.process_batch(streams[1:])
    for a, b in zip(live, cc.states):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    for s in (1, 2):
        one = port_chain(FLAGSHIP, 2048)
        one.states = [t.clone() if isinstance(t, torch.Tensor) else t for t in live]
        np.testing.assert_array_equal(batch[s - 1], one.process_array(streams[s]))


def test_batch_refuses_effects_without_a_stream_axis(streams):
    """Every effect takes the stream axis now: noise, once refused, runs
    each stream from the live key, as process_array does."""
    cc = port_chain("gain -3 noise -90", 2048)
    live = _clone(cc.states)
    batch = cc.process_batch(streams[:2, :4096])
    for s in range(2):
        cc.states = _clone(live)
        np.testing.assert_array_equal(batch[s], cc.process_array(streams[s, :4096]))


# --- the kernels' plain versions: S streams in one call ---------------------


def _rand(shape, seed, dtype=torch.float64, scale=0.3):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape) * scale, dtype=dtype)


def _equal_streams(call, states, xs):
    """call(state, x) -> (state', y) on S streams at once equals S
    one-stream calls, bit for bit (any nesting of tuples in the results)."""
    got = call(states, xs)
    for s in range(xs.shape[0]):
        one = call(_index(states, s), xs[s])
        _assert_tree_equal(_index(got, s), one)


def _index(tree, s):
    """Stream s of a tree of stream-axis tensors (a 0-dim counter is every
    stream's)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index(t, s) for t in tree)
    if isinstance(tree, dict):
        return {k: _index(v, s) for k, v in tree.items()}
    return tree if tree is None or tree.dim() == 0 else tree[s]


def _assert_tree_equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_tree_equal(u, v)
    elif isinstance(a, dict):
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif a is None:
        assert b is None
    else:
        assert a.shape == b.shape and torch.equal(a, b)


def _flagship_plan():
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.biquad import BiquadEffect

    chain = build_chain_from_string(FLAGSHIP, StreamInfo(FS, 2))
    return iir.CascadeBlockedPlan([e.c for e in chain.effects if type(e) is BiquadEffect])


@pytest.mark.parametrize("form", ["f64", "f32", "df"])
def test_k1_streams(form):
    plan = _flagship_plan()
    dt = torch.float32 if form != "f64" else torch.float64
    x = _rand((S, 1024, 2), 1, dt)
    st = _rand((S, 2, 2, plan.n), 2, dt, 1e-2)
    fn = {"f64": iir.lti_blocked, "f32": iir.lti_blocked, "df": iir.lti_blocked_df}[form]
    _equal_streams(lambda s_, x_: fn(plan, s_, x_), st, x)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_crossfeed_step_streams(dt):
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    cf = build_chain_from_string("crossfeed 700 4.5", StreamInfo(FS, 2)).effects[0]
    x = _rand((S, 700, 4), 3, dt)  # the pair at columns 3 and 1 of 4
    st = _rand((S, 4, 2), 4, dt, 1e-2)
    ss = "_ss32" if dt == torch.float32 else "_ss"
    A, Bv, c0 = (torch.as_tensor(getattr(cf, ss + k), dtype=dt) for k in ("_A", "_Bv", "_c0"))
    _equal_streams(lambda s_, x_: iir.crossfeed_step(A, Bv, c0, s_, x_, 3, 1, cf.direct_gain,
                                                     cf.cross_gain), st, x)


def _coupled(C, n=3):
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    words = " ".join(f"eq {100.0 * 4 ** s:.1f} 0.8 {3.0 if s % 2 else -2.0}" for s in range(n))
    effects = build_chain_from_string(words, StreamInfo(FS, C)).effects
    return tuple(torch.as_tensor(np.stack([getattr(e, k) for e in effects]))
                 for k in ("_ss_A", "_ss_Bv", "_ss_c0"))


@pytest.mark.parametrize("dt,pair", [(torch.float64, False), (torch.float64, True),
                                     (torch.float32, False), (torch.float32, True)],
                         ids=["f64", "f64 pair", "df1", "df"])
def test_biquad_run_streams(dt, pair):
    A, Bv, c0 = _coupled(2)
    x = _rand((S, 1000, 2), 5, dt)
    shape = (S, 2, 2, 2) if pair else (S, 2, 2)
    states = [_rand(shape, 6 + k, dt, 1e-2) for k in range(3)]
    got_ends, got_y = iir.biquad_scan_run(A, Bv, c0, states, x)
    for s in range(S):
        ends, y = iir.biquad_scan_run(A, Bv, c0, [t[s] for t in states], x[s])
        assert torch.equal(got_y[s], y)
        for g, e in zip(got_ends, ends):
            assert torch.equal(g[s], e)


@pytest.mark.parametrize("form", ["biquad_scan", "biquad_scan_f32", "biquad_scan_pair",
                                  "biquad_scan_df", "biquad_scan_df1"])
def test_lone_biquad_streams(form):
    A, Bv, c0 = (t[0] for t in _coupled(2, 1))
    dt = torch.float32 if form in ("biquad_scan_f32", "biquad_scan_df", "biquad_scan_df1") \
        else torch.float64
    if form == "biquad_scan_f32":
        A, Bv, c0 = A.float(), Bv.float(), c0.float()
    x = _rand((S, 777, 2), 7, dt)
    pair = form in ("biquad_scan_pair", "biquad_scan_df")
    st = _rand((S, 2, 2, 2) if pair else (S, 2, 2), 8, dt, 1e-2)
    fn = getattr(iir, "biquad_scan_df" if form == "biquad_scan_df1" else form)
    _equal_streams(lambda s_, x_: fn(A, Bv, c0, s_, x_), st, x)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_fft_wrappers_streams(dt):
    a, x = _rand((S, 300, 2), 9, dt), _rand((S, 512, 2), 10, dt)
    N = 1024
    X, kept = fc.rfft_pack(a, x, N, keep=400)
    for s in range(S):
        Xs, ks = fc.rfft_pack(a[s], x[s], N, keep=400)
        assert torch.equal(X[s], Xs) and torch.equal(kept[s], ks)
    H = _rand((4, N // 2 + 1, 2), 11).to(torch.complex128)
    fdl = _rand((S, 4, N // 2 + 1, 2, 2), 12, dt)
    _equal_streams(lambda f_, X_: fc.fdl_mac(X_, H, f_, dtype=dt), fdl, X)
    Y, _ = fc.fdl_mac(X, H, fdl, dtype=dt)
    add = _rand((S, 256, 2), 13, dt)
    out = fc.irfft_crop(Y, N, 100, 256, add, dtype=dt)
    for s in range(S):
        assert torch.equal(out[s], fc.irfft_crop(Y[s], N, 100, 256, add[s], dtype=dt))
    big = _rand((S, 900, 2), 14, dt)
    sp = fc.splice(big, x, 900, 200, 0)
    for s in range(S):
        assert torch.equal(sp[s], fc.splice(big[s], x[s], 900, 200, 0))


def _engine_state(eng, dt):
    """The engine's state0 on the CPU in dtype dt, with a stream axis of S
    (a 0-dim counter kept once)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(u) for k, u in v.items()}
        if isinstance(v, torch.Tensor):
            return v
        return torch.as_tensor(np.broadcast_to(v, (S,) + v.shape).copy(), dtype=dt)
    return conv(eng.state0())


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("engine", ["ols", "upols", "nupols"])
def test_fft_engine_steps_streams(engine, dt):
    rng = np.random.default_rng(15)
    B = 256
    if engine == "ols":
        eng = fc.OlsConv(rng.standard_normal((2, 300)) * 0.05, B)
    elif engine == "upols":
        eng = fc.UpolsConv(rng.standard_normal((2, 1500)) * 0.05, B)
    else:
        eng = fc.NupolsConv(rng.standard_normal((2, 2000)) * 0.05, B, 4)
    st = _engine_state(eng, dt)
    for blk in range(6):  # Nupols: blocks 0..3 a super-block, fires on 3
        x = _rand((S, B, 2), 16 + blk, dt)
        nxt, y = eng.step(st, x)
        for s in range(S):
            one_st, one_y = eng.step(_index(st, s), x[s])
            assert torch.equal(y[s], one_y)
            _assert_tree_equal(_index(nxt, s), one_st)
        st = nxt
    if engine == "nupols":
        assert int(st["cnt"]) == 2 and st["cnt"].dim() == 0


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("rate", [48000, 44101], ids=["one launch", "three launches"])
def test_resample_step_streams(rate, dt):
    rs = ro.SpectralResampler(FS, rate)
    assert rs.route == (ro.ONE_LAUNCH if rate == 48000 else ro.THREE_LAUNCHES)
    n = 2 if rate == 48000 else 1
    x = _rand((S, n * rs.in_len, 2), 17, dt)
    ov = _rand((S, rs.out_len, 2), 18, dt, 1e-2)
    _equal_streams(lambda o_, x_: ro.resample_step(rs, o_, x_), ov, x)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree
