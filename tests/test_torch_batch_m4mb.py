"""Batched processing of matrix4_mb (CompiledChain.process_batch) on the
CPU, and the stream axis of the kernels its step runs:

* process_batch of `matrix4_mb -6` over S = 2 streams of transients on 4
  blocks of 2048 in float64 against dsp_tpu's process_batch, which vmaps
  its step over the streams. The free run is chaotic where a band sits at
  crosstalk level (ROADMAP §3): held at -108 dBFS, the one-stream chain's
  limit (tests/test_torch_matrix4_mb_chain.py), about 30 dB above the
  measurement (-138.7 dBFS; that chain's on 1 s, -138.8);
* each stream bit-equal to the port's own process_array of that stream,
  in float64 and float32: the plain versions run a stream at a time;
* the stream-axis plain versions of the engines' kernels (m4mb_env and
  m4mb_env_f32 with the frequency mask's weights, m4mb_event,
  m4mb_event_f32, m4mb_audio, m4mb_audio_f32) at S = 3 on mid-stream
  states that differ by stream, bit-equal to three one-stream calls.

The bank, the fshape's runs and the splice took their stream axis earlier
(tests/test_torch_batch.py). About 40 s serial, 24 s of it the batch
against dsp_tpu's.
"""

import numpy as np
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from test_torch_batch_m4 import _assert_tree_equal, _index, chain
from test_torch_matrix4 import transient_signal
from torch_parity import FS, jax_chain, worst_dbfs

SPEC = "matrix4_mb -6"
BLOCKS = 4
# the one-stream chain's limit; the batch measured -138.7 dBFS
BATCH_LIMIT_DBFS = -108.0


def _streams(cc, S):
    """S streams of transients that with the chain's drain fill BLOCKS
    blocks of 2048."""
    n = BLOCKS * 2048 - cc.chain.drain_frames
    return np.stack([transient_signal(n / FS + 0.01, seed=40 + s)[:n] for s in range(S)])


def test_batch_matches_dsp_tpu_and_per_stream():
    cc = chain(SPEC, 2048, torch.float64)
    xs = _streams(cc, 2)
    batch = cc.process_batch(xs)
    ref = np.asarray(jax_chain(SPEC, 2048).process_batch(xs))
    assert batch.shape == ref.shape
    print(f"{SPEC} batch of 2 against dsp_tpu's: {worst_dbfs(batch, ref):.1f} dBFS")
    assert worst_dbfs(batch, ref) <= BATCH_LIMIT_DBFS
    for s in range(2):
        cc.reset()
        np.testing.assert_array_equal(batch[s], cc.process_array(xs[s]))


def test_batch_streams_equal_process_array_f32():
    cc = chain(SPEC, 2048, torch.float32)
    xs = _streams(cc, 2)
    batch = cc.process_batch(xs)
    for s in range(2):
        cc.reset()
        np.testing.assert_array_equal(batch[s], cc.process_array(xs[s]))


def _mid_stream(dtype, S=3, B=1024, blocks=4):
    """The matrix4_mb effect and its stream-axis state after `blocks` blocks
    of S streams of transients from 0.09 s on (past each stream's first
    events), and the next block's bands [S, B, 13, 2] (the bank's (hi, lo)
    output under float32)."""
    from dsp_tpu_torch.ops import iir

    cc = chain(SPEC, B, dtype)
    n, n0 = (blocks + 1) * B, int(0.09 * FS)
    xs = torch.as_tensor(np.stack([transient_signal((n0 + n) / FS + 0.01, seed=50 + s)[n0:n0 + n]
                                   for s in range(S)]), dtype=dtype)
    states = cc._stream_states(cc.states, S)
    for b in range(blocks):
        states, _ = cc._step(states, xs[:, b * B:(b + 1) * B].contiguous())
    e, st = cc._runtime_effects[1], states[1]
    ev = st["ev"]
    assert int(ev["diff_count"].sum()) + int(ev["ord_count"].sum()) > 0, "no event yet"
    x = xs[:, blocks * B:].contiguous()
    _, s_pre = e._cascade("fsh", st["fshape_m"].reshape(S, 2, 2, 2), x)
    xt = s_pre.repeat(1, 1, 13)
    if dtype == torch.float32:
        _, (hi, lo) = iir.lti_blocked_df(e._bank_plan(B), st["bank"]["fused"], xt)
        return e, st, (hi.view(S, B, 13, 2), lo.view(S, B, 13, 2))
    _, yb = iir.lti_blocked(e._bank_plan(B), st["bank"]["fused"], xt)
    return e, st, (yb.view(S, B, 13, 2),)


def _equal_streams(fn, streamed, S=3):
    got = fn(*streamed)
    for s in range(S):
        _assert_tree_equal(_index(got, s), fn(*_index(list(streamed), s)))
    return got


def test_plain_forms_streams_f64():
    from dsp_tpu_torch.ops import m4_engine as m4

    e, st, (bands,) = _mid_stream(torch.float64)
    w = torch.as_tensor(m4.band_mix_weights(0.5))
    _equal_streams(lambda b_, m_: m4.m4mb_env(b_, m_, e.g_env, w), (bands, st["env_m"]))
    _, env_ds = _equal_streams(lambda b_, m_: m4.m4mb_env(b_, m_, e.g_env), (bands, st["env_m"]))
    assert env_ds.shape == (3, bands.shape[1] // 32, 13, 8)
    out = _equal_streams(lambda *a: m4.m4mb_event(e.ctl, *a, 0, False),
                         (st["ev"], st["ev_thresh"], env_ds, st["interp_y"]))
    _equal_streams(lambda *a: m4.m4mb_audio(e.audio, *a),
                   (bands, st["fb_buf"], st["interp_c"], out[2], st["pf_m"]))


def test_plain_forms_streams_f32():
    from dsp_tpu_torch.ops import m4_engine as m4

    e, st, (hi, lo) = _mid_stream(torch.float32)
    w = torch.as_tensor(m4.band_mix_weights(0.5))
    _equal_streams(lambda *a: m4.m4mb_env_f32(*a, e.g_env, w),
                   (hi, lo, st["env_m"], st["env_m_lo"]))
    *_, env_ds = _equal_streams(lambda *a: m4.m4mb_env_f32(*a, e.g_env),
                                (hi, lo, st["env_m"], st["env_m_lo"]))
    out = _equal_streams(lambda *a: m4.m4mb_event_f32(e.ctl, *a, 0, False),
                         (st["ev"], st["ev_lo"], st["ev_thresh"], st["ev_thresh_lo"], env_ds,
                          st["interp_y"]))
    _equal_streams(lambda *a: m4.m4mb_audio_f32(e.audio, *a),
                   (hi, st["fb_buf"], st["interp_c"], out[4], st["pf_m"]))
