"""How csrc/stats.cu's plain mode (K16) cuts a block into tiles, on the CPU,
against the plain version and dsp_tpu.

The kernel runs a block in one launch: tiles of 256 samples (of up to 8
channels), each lane of a warp a segment of 8 samples. A tile publishes its
channels' min and max; the running min and max a sample is compared with
are the carried state's, every earlier tile's (folded in any order: min and
max are exact) and the earlier segments' of its own tile (a warp scan);
each segment keeps (pk, cnt, first), the largest |x| of an event, how many
events equal it and the first, which combine exactly (the larger pk wins,
on a tie the counts add and the earlier frame stays), so one pass finds the
block's peak, count and frame; the float64 sums run in order within a
segment, over the segments in the warp's xor tree and over the tiles in
tile order. stats_plain_model below is that partition in Python floats
(float32 samples are exact in them; min, max, abs and comparisons too).

Held: every decision, min, max, peak, peak_count and peak_frame equal to
stats_step_ref's (_stats_plain_ref: the vectorized cummin/cummax form), the
sums within 1e-12 relative (another order), on quantized input (ties),
a new peak in a late tile, a limit inside a tile and n_act = 0, B = 1, a B
that is not a multiple of the tile and B = 65,536, one selected channel,
-0.0 and +0.0 minima, in both dtypes; and at one shape against dsp_tpu's
StatsEffect._step_plain.
"""

import math

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from dsp_tpu_torch.ops import time_domain as td

TILE, SEG = 256, 8  # csrc/stats.cu kTile, kSeg
NONE = 1 << 62
DTYPES = [torch.float64, torch.float32]


def _jmin(a, b):
    return a if (a < b or (a == b and math.copysign(1.0, a) < 0)) else b


def _jmax(a, b):
    return a if (a > b or (a == b and math.copysign(1.0, a) > 0)) else b


def _combine(p, q):
    """(pk, cnt, first) of two segments or tiles, exactly."""
    if q[0] > p[0]:
        return q
    if q[0] == p[0]:
        return (p[0], p[1] + q[1], min(p[2], q[2]))
    return p


def _xor_tree(v):
    """Lane 0's value after the warp's xor butterfly of sums."""
    v = list(v)
    for d in (16, 8, 4, 2, 1):
        v = [v[i] + v[i ^ d] for i in range(32)]
    return v[0]


def stats_plain_model(s, xs):
    """The kernel's partition: the new state's plain leaves as Python
    numbers (sums as the kernel adds them, before the float32 rounding)."""
    B, n = xs.shape
    s0, lim = int(s["samples"]), int(s["limit"])
    n_act = max(0, min(B, lim - s0))
    ntiles = -(-B // TILE)
    x_all = xs.to(torch.float64).numpy()
    out = {k: [] for k in ("sum", "sum_sq", "min", "max", "peak", "peak_count", "peak_frame")}
    for c in range(n):
        x = x_all[:n_act, c].tolist()
        mn0, mx0, pk0 = (float(s[k][c]) for k in ("min", "max", "peak"))
        tiles = [x[t * TILE:(t + 1) * TILE] for t in range(ntiles)]
        aggs = []  # each tile's (min, max) in jnp's order
        for tx in tiles:
            a, b = math.inf, -math.inf
            for v in tx:
                a, b = _jmin(a, v), _jmax(b, v)
            aggs.append((a, b))
        block_sum = block_sq = 0.0
        best = (0.0, 0, NONE)
        for t, tx in enumerate(tiles):
            pmn, pmx = mn0, mx0
            for a, b in aggs[:t]:  # any order: exact
                pmn, pmx = _jmin(pmn, a), _jmax(pmx, b)
            segs = [tx[l * SEG:(l + 1) * SEG] for l in range(32)]
            sums, sqs, tile_best = [], [], (0.0, 0, NONE)
            run_mn, run_mx = pmn, pmx
            for l, sg in enumerate(segs):
                # the warp scan hands the segment the running min and max of
                # the segments before it
                seg_best, sm, sq = (0.0, 0, NONE), 0.0, 0.0
                for i, v in enumerate(sg):
                    sm += v
                    sq += v * v
                    if v <= run_mn or v >= run_mx:
                        a = abs(v)
                        if a > seg_best[0]:
                            seg_best = (a, 1, t * TILE + l * SEG + i)
                        elif a == seg_best[0] and a > 0:
                            seg_best = (a, seg_best[1] + 1, seg_best[2])
                    run_mn, run_mx = min(run_mn, v), max(run_mx, v)
                sums.append(sm)
                sqs.append(sq)
                tile_best = _combine(tile_best, seg_best)
            block_sum += _xor_tree(sums)
            block_sq += _xor_tree(sqs)
            best = _combine(best, tile_best)
        pk, cnt, first = best
        peak = max(pk0, pk)
        higher = peak > pk0
        bc = cnt if pk == peak else 0
        bmn, bmx = mn0, mx0
        for a, b in aggs:
            bmn, bmx = _jmin(bmn, a), _jmax(bmx, b)
        out["sum"].append(float(s["sum"][c]) + block_sum)
        out["sum_sq"].append(float(s["sum_sq"][c]) + block_sq)
        out["min"].append(bmn)
        out["max"].append(bmx)
        out["peak"].append(peak)
        out["peak_count"].append(bc if higher else int(s["peak_count"][c]) + bc)
        out["peak_frame"].append(s0 + first if higher else int(s["peak_frame"][c]))
    return out


def _state(n, dtype, rng=None, samples=0, limit=NONE):
    st = {k: torch.zeros(n, dtype=dtype) for k in ("sum", "sum_sq", "min", "max", "peak")}
    st.update(peak_count=torch.zeros(n, dtype=torch.int64),
              peak_frame=torch.zeros(n, dtype=torch.int64),
              samples=torch.tensor(samples, dtype=torch.int64),
              limit=torch.tensor(limit, dtype=torch.int64))
    if rng is not None:
        st["sum"] = torch.as_tensor(rng.standard_normal(n)).to(dtype)
        st["sum_sq"] = torch.as_tensor(rng.uniform(1, 2, n)).to(dtype)
        st["min"] = torch.as_tensor(-rng.uniform(0.1, 0.3, n)).to(dtype)
        st["max"] = torch.as_tensor(rng.uniform(0.1, 0.3, n)).to(dtype)
        st["peak"] = torch.maximum(-st["min"], st["max"])
        st["peak_count"] = torch.as_tensor(rng.integers(1, 5, n))
        st["peak_frame"] = torch.as_tensor(rng.integers(0, max(1, samples), n))
    return st


def _hold(st, xs):
    """The model against stats_step_ref: decisions and extremes equal, sums
    within 1e-12 relative (float32: rounded once, as the kernel stores them)."""
    want = td.stats_step_ref(st, xs)
    got = stats_plain_model(st, xs)
    dt = xs.dtype
    for k in ("min", "max", "peak"):
        g = torch.tensor(got[k], dtype=torch.float64).to(dt)
        assert torch.equal(g, want[k]), k
        assert torch.equal(torch.signbit(g), torch.signbit(want[k])), k
    for k in ("peak_count", "peak_frame"):
        assert got[k] == want[k].tolist(), k
    for k in ("sum", "sum_sq"):
        g = torch.tensor(got[k], dtype=torch.float64).to(dt).to(torch.float64)
        w = want[k].to(torch.float64)
        tol = 1e-12 if dt == torch.float64 else 2.0 ** -23  # float32: one rounding apart
        assert float((g - w).abs().max()) <= tol * max(1.0, float(w.abs().max())), k
    return want


def _quantized(rng, B, n, bits=8):
    return np.round(rng.standard_normal((B, n)) * 0.3 * 2 ** bits) / 2 ** bits


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("B", [1, 1000, 2048, 65536])
def test_quantized_blocks_over_a_carried_state(B, dtype):
    """Ties: quantized input, three blocks from a carried state (the counts
    add across blocks), at B = 1, a B that is no multiple of the tile, 2048
    and 65,536."""
    rng = np.random.default_rng(B)
    st = _state(2, dtype, rng, samples=5000)
    for _ in range(3):
        xs = torch.as_tensor(_quantized(rng, B, 2, bits=4 if B > 1000 else 8)).to(dtype)
        st = _hold(st, xs)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_new_peak_in_a_late_tile_restarts_the_count(dtype):
    rng = np.random.default_rng(3)
    B = 4096
    x = _quantized(rng, B, 2) * 0.5
    x[[10, 300, 900], 0] = 0.875  # ties of the first tiles' peak
    x[[10, 300], 1] = -0.875
    x[3900, 0] = 1.5  # a new peak in tile 15
    x[[3950, 4000], 0] = [-1.5, 1.5]  # new minima / maxima equal to it
    x[2600, 1] = -1.25
    xs = torch.as_tensor(x).to(dtype)
    st = _state(2, dtype, samples=70)
    new = _hold(st, xs)
    assert new["peak_count"].tolist()[0] == 3 and new["peak_frame"].tolist()[0] == 70 + 3900
    assert new["peak_frame"].tolist()[1] == 70 + 2600


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("limit", [3, 700, 1000, 1024, 0])
def test_limit_inside_a_tile(limit, dtype):
    """The limit read on the device: active samples stop inside a tile (700,
    1000), on a tile's edge (1024), after 3, or before the block (n_act =
    0: nothing moves but samples')."""
    rng = np.random.default_rng(limit)
    samples = 2000
    st = _state(2, dtype, rng, samples=samples, limit=samples + limit - (5 if limit == 0 else 0))
    xs = torch.as_tensor(_quantized(rng, 2048, 2)).to(dtype)
    new = _hold(st, xs)
    if limit == 0:
        for k in ("min", "max", "peak", "peak_count", "peak_frame"):
            assert torch.equal(new[k], st[k]), k


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_one_selected_channel(dtype):
    """`:1 stats`: the kernel sees n = 1 (the wrapper's channel pick)."""
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.stats import StatsEffect

    e = StatsEffect("stats", StreamInfo(44100, 2), np.array([False, True]), None, 80, False)
    rng = np.random.default_rng(11)
    x = torch.as_tensor(_quantized(rng, 1500, 2)).to(dtype)
    xs = e._pick.take(x)
    assert tuple(xs.shape) == (1500, 1)
    st = {k: torch.as_tensor(v) for k, v in e.state0().items()}
    st = {k: v.to(dtype) if v.is_floating_point() else v for k, v in st.items()}
    _hold(st, xs)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_signed_zero_minima(dtype):
    """-0.0 orders below +0.0 in min (and +0.0 above -0.0 in max), as
    jnp.minimum does, wherever the zeros sit among the tiles."""
    B = 1024
    for case in range(4):
        x = np.full((B, 2), 0.25)
        x[:, 1] = -0.25
        if case == 0:
            x[700, 0] = -0.0
            x[100, 0] = 0.0
        elif case == 1:
            x[100, 0], x[700, 0] = -0.0, 0.0
        elif case == 2:
            x[:, 0] = 0.0
            x[900, 0] = -0.0
        else:
            x[:, :] = -0.0
            x[5, 1] = 0.0
        st = _state(2, dtype)  # min and max start at +0.0
        new = _hold(st, torch.as_tensor(x).to(dtype))
        if case == 2:
            assert torch.signbit(new["min"][0])
        if case == 3:
            assert torch.signbit(new["min"]).all() and not torch.signbit(new["max"]).any()


def test_against_dsp_tpu_step_plain():
    """The model against dsp_tpu's StatsEffect._step_plain at one shape:
    three quantized blocks of 2048 with a limit in the third."""
    import jax.numpy as jnp

    import dsp_tpu  # noqa: F401  (its config turns on jax's float64)
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.stats import StatsEffect as JStats

    j = JStats("stats", JStream(44100, 2), np.ones(2, dtype=bool), None, 80, False)
    st_j = {k: jnp.asarray(v) for k, v in j.state0().items()}
    st = _state(2, torch.float64)
    rng = np.random.default_rng(99)
    for blk in range(3):
        x = _quantized(rng, 2048, 2)
        x[1000 + blk] = [1.5, -1.5]
        if blk == 2:
            st_j = j.set_valid_limit(st_j, 4096 + 777)
            st["limit"] = torch.tensor(4096 + 777)
        got = stats_plain_model(st, torch.as_tensor(x))
        st_j, _ = j.step(st_j, jnp.asarray(x))
        for k in ("min", "max", "peak", "peak_count", "peak_frame"):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(st_j[k]), err_msg=k)
        for k in ("sum", "sum_sq"):
            np.testing.assert_allclose(got[k], np.asarray(st_j[k]), rtol=1e-12, atol=0)
        st = td.stats_step_ref(st, torch.as_tensor(x))
    assert int(st_j["peak_count"][0]) == 2
