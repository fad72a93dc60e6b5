"""What the matrix4 event engines' kernel (csrc/m4_event.cu) may compute
ahead of its serial chain, and the launch geometry it is given, on the CPU.

The kernel's pre-phase computes, for a chunk of ticks at once, the values
of a tick that no decision touches: the ordering and its lowpass, the accom
EWMAs, the adapted powers' angles (diff_lr / diff_cs), the fast norms and
the masks, and writes the ord_buf, ord_lp_buf and diff_buf rings from them.
That is right only if those values depend on the envelopes and on their own
leaves alone. The first test pins it against the reference: two event
states that agree on the decision-free leaves and differ in every other one
run the same transient envelopes through dsp_tpu's event_step (float64, jax
on the CPU) and through the port's; the decision-free leaves and ring
entries must come out bit-equal between the two states in both packages,
and equal across the packages (the port holds dsp_tpu's event_step to
1e-12 relative elsewhere, tests/test_torch_matrix4.py; here the values are
compared to the same bound and reported).

The others hold ops/m4_engine.event_geometry, the one place that sizes an
engine launch, at every rate from 32 kHz to 768 kHz and the blocks the
upmixes run: shared memory within a Hopper block's 232,448 bytes, at least
one tick a chunk, chunks that cover the block's ticks, and the rings in a
device scratch only where they would not fit in shared memory (matrix4_mb
from 461.9 kHz).
"""

import math

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)

FS = 44100
TICKS = 48
# the leaves the pre-phase owns or writes from its values, and the two
# counters that advance alike; norm is held on its fast half only (norm[2:4])
FREE = ("ord_lp_m", "accom", "ord_buf", "ord_lp_buf", "diff_buf", "buf_p", "t")


def _envelopes(seed):
    """[TICKS, 8] envelopes (l, r, sum, diff, then their powers): a quiet
    bed with noise, and three decaying bursts, panned left, right and to
    the rear."""
    rng = np.random.default_rng(seed)
    i = np.arange(TICKS)
    lr = 0.01 * (1.0 + 0.2 * rng.random((TICKS, 2)))
    for start, pan in ((5, (1.0, 0.1)), (20, (0.1, 1.0)), (35, (0.7, -0.7))):
        burst = np.where(i >= start, 0.5 * np.exp(-(i - start) / 4.0), 0.0)
        lr += burst[:, None] * np.abs(np.array(pan))[None, :]
    sd = np.stack([np.abs(lr[:, 0] + lr[:, 1]) * 0.5, np.abs(lr[:, 0] - lr[:, 1]) * 0.5 + 1e-4], 1)
    env = np.concatenate([lr, sd], 1)
    return np.concatenate([env, env ** 2 * (1.0 + 0.05 * rng.random((TICKS, 4)))], 1)


def _states(p, seed):
    """Two event states with the same decision-free leaves and every other
    leaf different (flags flipped, counters and stamps moved, floats
    drawn)."""
    from dsp_tpu_torch.ops import m4_engine as m4

    rng = np.random.default_rng(seed)
    a = {k: np.array(v) for k, v in m4.make_event_state(p).items()}
    L = p["buf_len"]
    a["accom"] = rng.uniform(1e-5, 1e-3, 6)
    a["ord_lp_m"] = rng.uniform(-0.05, 0.05, (2, 2))
    a["norm"] = rng.uniform(1e-5, 1e-3, 4)
    for k in ("ord_buf", "ord_lp_buf", "diff_buf"):
        a[k] = rng.uniform(-0.7, 0.7, (L, 2))
    a["buf_p"], a["t"] = np.int64(7), np.int64(100)
    b = {k: v.copy() for k, v in a.items()}
    for k, kind in m4.EV_LEAVES:
        if k in FREE or k == "norm":
            continue
        if kind == "b":
            b[k] = ~a[k]
        elif kind == "i":
            b[k] = a[k] + rng.integers(3, 40)
        else:
            b[k] = a[k] + rng.uniform(0.05, 0.5, np.shape(a[k]))
    b["norm"][:2] = a["norm"][:2] * 3.0  # the slow norms are the chain's
    b["t_hold"] = np.int64(99)  # a fuse instead of a fresh event
    return a, b


def _free(st, lane=None):
    """The decision-free leaves of one state as numpy arrays."""
    pick = (lambda v: np.asarray(v)) if lane is None else (lambda v: v[lane].numpy())
    out = {k: pick(st[k]) for k in FREE + ("diff_last",)}
    out["norm23"] = pick(st["norm"])[2:4]
    return out


def test_decision_free_leaves_do_not_depend_on_the_decisions():
    import jax
    import jax.numpy as jnp

    from dsp_tpu.ops import m4_engine as jm4
    from dsp_tpu_torch.ops import m4_engine as m4

    jp_host = jm4.make_event_params(FS / 32)
    p = m4.host_params(m4.make_event_params(FS / 32))
    jp = jm4.cast_params(jp_host, jnp.float64)
    env = _envelopes(11)
    a, b = _states(jp_host, 12)

    @jax.jit
    def jstep(st, e8):
        e = {"l": e8[0], "r": e8[1], "sum": e8[2], "diff": e8[3]}
        w = {"l": e8[4], "r": e8[5], "sum": e8[6], "diff": e8[7]}
        return jm4.event_step(jp, st, e, w, 1.0)

    jst = [{k: jnp.asarray(v) for k, v in s.items()} for s in (a, b)]
    st = {k: torch.as_tensor(np.stack([a[k], b[k]])) for k in a}
    worst, moved = 0.0, set()
    for i in range(TICKS):
        e8 = torch.as_tensor(np.stack([env[i], env[i]]))
        st, out = m4.event_step(p, st, {k: e8[:, j] for j, k in enumerate(("l", "r", "sum", "diff"))},
                                {k: e8[:, 4 + j] for j, k in enumerate(("l", "r", "sum", "diff"))})
        jst = [jstep(s, jnp.asarray(env[i]))[0] for s in jst]
        port = [_free(st, lane) for lane in (0, 1)]
        ref = [_free(s) for s in jst]
        for k in port[0]:
            assert np.array_equal(port[0][k], port[1][k]), ("port", i, k)
            assert np.array_equal(ref[0][k], ref[1][k]), ("dsp_tpu", i, k)
            d = np.abs(port[0][k].astype(np.float64) - ref[0][k].astype(np.float64)).max()
            worst = max(worst, float(d) / max(1.0, float(np.abs(ref[0][k]).max())))
        moved |= {k for k, kind in m4.EV_LEAVES if k not in FREE
                  and not np.array_equal(np.asarray(jst[0][k]), np.asarray(jst[1][k]))}
    # the two states' decisions went their own ways throughout
    assert {"hold", "ord_factor", "drift", "t_hold", "svf_m", "diff_count"} <= moved, moved
    print(f"decision-free leaves, port against dsp_tpu: {worst:.3e} relative")
    assert worst <= 1e-12, worst


def _hold_geometry(fs, bands, Nc, L, geo):
    from dsp_tpu_torch.ops import m4_engine as m4

    threads, chunk, smem, ring = geo
    n_chunks = math.ceil(Nc / chunk)
    where = (fs, bands, Nc, L, geo)
    assert threads % 32 == 0 and 96 <= threads <= 256, where
    assert 1 <= chunk <= 32, where
    assert n_chunks * chunk >= Nc and (n_chunks - 1) * chunk < Nc, where
    assert smem <= 232448, where
    rings = 8 * bands * 10 * L
    if ring == 0:
        # the rings in shared memory, beside the chunk tables
        assert smem >= rings, where
    else:
        # the rings in a device scratch only where they would not fit
        # beside a chunk of one tick
        assert ring == bands * 10 * L, where
        one_tick = 2 * bands * (m4.EVENT_TABLE_SLOTS + m4.EVENT_OUTPUTS)
        if bands == m4.N_BANDS:
            one_tick += 2 * bands * bands + 2 * bands  # the similarity terms, the diffs
        assert rings + 8 * one_tick > 232448, where


@pytest.mark.parametrize("fs", [44100, 48000, 96000, 192000])
def test_event_geometry_fits_every_launch(fs):
    from dsp_tpu_torch.ops import m4_engine as m4

    L = m4.make_event_params(fs / 32)["buf_len"]
    for bands in (1, m4.N_BANDS):
        for B in (1056, 2048, 8192, 65536):
            Nc = B // 32
            geo = m4.event_geometry(bands, L, Nc)
            _hold_geometry(fs, bands, Nc, L, geo)
            # up to 192 kHz the rings sit in shared memory, as before
            assert geo[3] == 0, (fs, bands, B, geo)


# matrix4_mb's 13 bands' rings outgrow a block's shared memory from buf_len
# 217 (461.9 kHz; 470.4 kHz: buf_len 221, 229,840 bytes of rings); dsp_tpu
# takes any rate from 32 kHz (dsp_tpu/effects/matrix4.py:79-80)
@pytest.mark.parametrize("fs", [32000, 88200, 176400, 352800, 384000, 441000, 470400, 705600,
                                768000])
def test_event_geometry_launches_at_high_rates(fs):
    from dsp_tpu_torch.ops import m4_engine as m4

    L = m4.make_event_params(fs / 32)["buf_len"]
    for bands in (1, m4.N_BANDS):
        for Nc in (64, 2048):
            geo = m4.event_geometry(bands, L, Nc)
            _hold_geometry(fs, bands, Nc, L, geo)
            assert (geo[3] > 0) == (bands == m4.N_BANDS and fs > 441000), (fs, bands, Nc, geo)


def test_event_geometry_launches_at_every_rate():
    """Every rate from 32 kHz to 768 kHz in steps of 100 Hz, with buf_len
    from the engine's own parameters."""
    from dsp_tpu_torch.ops import m4_engine as m4

    seen = set()
    for fs in range(32000, 768001, 100):
        L = m4.make_event_params(fs / 32)["buf_len"]
        for bands in (1, m4.N_BANDS):
            for Nc in (64, 2048):
                if (L, bands, Nc) in seen:
                    continue
                seen.add((L, bands, Nc))
                _hold_geometry(fs, bands, Nc, L, m4.event_geometry(bands, L, Nc))
    assert len(seen) > 4 * 300, len(seen)
