"""Batched processing of matrix4 (CompiledChain.process_batch) on the CPU,
and the stream axis of the kernels its step runs (the batch against
dsp_tpu's is tests/test_torch_batch_m4_jax.py):

* process_batch of `matrix4 -6` over S = 3 streams of transients, each
  stream bit-equal to the port's own process_array of that stream,
  in float64 and float32: the plain versions run a stream at a time;
* the stream-axis plain versions of the step's kernels (the float64
  band-limit pair biquad_scan_series, m4_env, m4_env_f32, m4_event,
  m4_event_f32, m4_audio, m4_audio_f32) at S = 3 on mid-stream states
  that differ by stream, bit-equal to three one-stream calls;
* CompiledChain._stream_states: every event leaf gets the stream axis;
  the host's leaves (matrix4's fade_p and disable, NupolsConv's cnt) stay
  one for all streams;
* a chain of matrix4 and one of the time-domain effects (stats, levels,
  noise, dither, the modulated delay), which process_batch once refused,
  accepted: each stream equal to process_array of that stream from the
  live state.

About 24 s serial.
"""

import numpy as np
import pytest
import torch

from test_torch_matrix4 import transient_signal
from torch_parity import FS, port_chain

S = 3
SPEC = "matrix4 -6"
SECONDS = 0.3


def batch_streams():
    """S streams of transients, each its own seed: events sample and hold
    at other ticks in each stream."""
    return np.stack([transient_signal(SECONDS, seed=20 + s) for s in range(S)])


@pytest.fixture(scope="module")
def streams():
    return batch_streams()


@pytest.fixture(scope="module")
def port_batches(streams):
    """The port's process_batch of the streams in each dtype, and the chains
    that rendered them (live state untouched)."""
    out = {}
    for dt in (torch.float64, torch.float32):
        cc = chain(SPEC, 2048, dt)
        out[dt] = (cc, cc.process_batch(streams))
    return out


def chain(spec, block, dtype):
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    return CompiledChain(build_chain_from_string(spec, StreamInfo(FS, 2)), block, dtype=dtype,
                         device="cpu")


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_batch_streams_equal_process_array(streams, port_batches, dt):
    cc, batch = port_batches[dt]
    events = 0
    for s in range(S):
        cc.reset()
        np.testing.assert_array_equal(batch[s], cc.process_array(streams[s]))
        ev = cc.states[0]["ev"]
        events += int(ev["diff_count"]) + int(ev["ord_count"])
    assert events > 0, "no event in the streams"


def _index(tree, s):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index(t, s) for t in tree)
    if isinstance(tree, dict):
        return {k: _index(v, s) for k, v in tree.items()}
    return tree if tree.dim() == 0 else tree[s]


def _assert_tree_equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_tree_equal(u, v)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _equal_streams(fn, streamed, *host):
    """fn(*streamed, *host) on S streams at once equals S one-stream calls,
    bit for bit; returns the stream-axis result."""
    got = fn(*streamed, *host)
    for s in range(S):
        _assert_tree_equal(_index(got, s), fn(*_index(list(streamed), s), *host))
    return got


def _mid_stream(dtype, B=1024, blocks=4):
    """The effect and its stream-axis state after `blocks` blocks of three
    streams of transients from 0.09 s on (each stream's engine in its own
    state, past its first events), and the next block [S, B, 2]."""
    cc = chain(SPEC, B, dtype)
    n, n0 = (blocks + 1) * B, int(0.09 * FS)
    xs = torch.as_tensor(np.stack([transient_signal((n0 + n) / FS + 0.01, seed=30 + s)[n0:n0 + n]
                                   for s in range(S)]), dtype=dtype)
    states = cc._stream_states(cc.states, S)
    for b in range(blocks):
        states, _ = cc._step(states, xs[:, b * B:(b + 1) * B].contiguous())
    ev = states[0]["ev"]
    assert int(ev["diff_count"].sum()) + int(ev["ord_count"].sum()) > 0, "no event yet"
    return cc._runtime_effects[0], states[0], xs[:, blocks * B:].contiguous()


def test_plain_forms_streams_f64():
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    e, st, x = _mid_stream(torch.float64)
    coef = tuple(torch.as_tensor(getattr(e, k)) for k in ("A_bl", "B_bl", "c0_bl"))
    _, y = _equal_streams(lambda s_, x_: iir.biquad_scan_series(*coef, s_, x_), (st["bp_m"], x))
    _, env_ds = _equal_streams(lambda y_, m_: m4.m4_env(y_, m_, e.g_env), (y, st["env_m"]))
    assert env_ds.shape == (S, x.shape[1] // 32, 8)
    # the engine's lanes are the streams: a lane of an S-lane call against a
    # one-lane call
    out = m4.m4_event(e.ctl, st["ev"], st["bg_cs"], env_ds, st["interp_y"], 0, False)
    for s in range(S):
        one = m4.m4_event(e.ctl, {k: v[s:s + 1] for k, v in st["ev"].items()},
                          st["bg_cs"][s:s + 1], env_ds[s:s + 1], st["interp_y"][s:s + 1], 0, False)
        _assert_tree_equal(_index(out, s), _index(one, 0))
    ics = out[2]
    _equal_streams(lambda *a: m4.m4_audio(e.audio, *a),
                   (x, st["buf"], st["interp_c"], ics, st["shelf_m"], st["lp_m"], st["pf_m"]))


def test_plain_forms_streams_f32():
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    e, st, x = _mid_stream(torch.float32)
    _, (hi, lo) = iir.lti_blocked_df(e._bp_plan(x.shape[1]), st["bpc"], x)
    *_, env_ds = _equal_streams(lambda *a: m4.m4_env_f32(*a, e.g_env),
                                (hi, lo, st["env_m"], st["env_m_lo"]))
    out = m4.m4_event_f32(e.ctl, st["ev"], st["ev_lo"], st["bg_cs"], st["bg_cs_lo"], env_ds,
                          st["interp_y"], 0, False)
    for s in range(S):
        lane = slice(s, s + 1)
        one = m4.m4_event_f32(e.ctl, {k: v[lane] for k, v in st["ev"].items()},
                              {k: v[lane] for k, v in st["ev_lo"].items()}, st["bg_cs"][lane],
                              st["bg_cs_lo"][lane], env_ds[lane], st["interp_y"][lane], 0, False)
        _assert_tree_equal(_index(out, s), _index(one, 0))
    _equal_streams(lambda *a: m4.m4_audio_f32(e.audio, *a),
                   (x, st["buf"], st["interp_c"], out[4], st["shelf_m"], st["lp_m"], st["pf_m"]))


def test_stream_states_give_every_event_leaf_a_stream():
    from dsp_tpu_torch.ops import m4_engine as m4

    cc = port_chain(SPEC, 2048)
    live = cc.states[0]
    st = cc._stream_states(cc.states, S)[0]
    for k, _ in m4.EV_LEAVES:
        assert st["ev"][k].shape == (S, *live["ev"][k].shape), k
    for k in ("bp_m", "env_m", "bg_cs", "interp_y", "interp_c", "buf", "aux"):
        assert st[k].shape == (S, *live[k].shape), k
    for k in ("fade_p", "disable"):  # one for all streams, the group's own copy
        assert st[k] is not live[k] and torch.equal(st[k], live[k]), k
        assert st[k].dim() == 0 and st[k].device.type == "cpu", k
    # NupolsConv's block counter: one for all streams, the group's own copy
    rng = np.random.default_rng(1)
    spec = "fir_p coefs:" + ",".join(f"{v:.5f}" for v in rng.uniform(-0.1, 0.1, 9000))
    cc = port_chain(spec, 128)  # 71 partitions of 128: the Nupols engine
    st = cc._stream_states(cc.states, S)[0]
    assert st["cnt"] is not cc.states[0]["cnt"] and torch.equal(st["cnt"], cc.states[0]["cnt"])
    assert st["cnt"].dim() == 0 and st["cnt"].device.type == "cpu"
    assert st["stage"].shape == (S, *cc.states[0]["stage"].shape)


@pytest.mark.parametrize("spec", ["stats", "levels", "noise -90", "dither",
                                  "delay -M 0.5m -q 2 10m"],
                         ids=["stats", "levels", "noise", "dither", "delay -M"])
def test_batch_still_refuses_effects_without_a_stream_axis(spec, streams):
    """matrix4 and each of the five time-domain effects, which have their
    stream axis now: a batch of 2 streams runs, each stream equal to
    process_array of that stream from the live state (the live keys)."""
    cc = port_chain(f"matrix4 -6 {spec}", 2048)
    live = _clone(cc.states)
    xs = streams[:2, :2048]
    batch = cc.process_batch(xs)
    for s in range(2):
        cc.states = _clone(live)
        np.testing.assert_array_equal(batch[s], cc.process_array(xs[s]))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree
