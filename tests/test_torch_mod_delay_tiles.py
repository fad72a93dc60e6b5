"""How csrc/mod_delay.cu (K14) cuts a modulated-delay step into tiles, on
the CPU, against the plain version and dsp_tpu.

The kernel runs a block in tiles of 128 samples, one launch: each tile
draws only the knots its samples read, rows floor(t0 + step·n0) ..
floor(t0 + step·n1) + 3 (the last tile's also reach the next knot window),
from their threefry counters ((i·6 + j)·2 + s)·lanes + l; and the blocks
write the carried line, the last H rows of [buf | x], into a new tensor,
so that the effect's step makes no splice of its own. Here:

* the knots a tile draws from its counters alone equal, bit for bit, the
  same rows of the whole block's draw, in float64 and float32, at the
  default modulation bandwidth and at one that spans dozens of rows a
  tile; and the whole draw equals the draw of the block's uniforms at
  once (the form the plain version had);
* the line mod_delay_ref returns equals fft_conv.splice_ref of the old
  line and the block (what the effect spliced before), bit for bit, for
  blocks shorter than the line, as long and longer, in both dtypes;
* a modulated chain stepped over many blocks, shorter and longer than the
  line, matches dsp_tpu within -280 dBFS, its line and key bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import CHAIN_LIMIT_DBFS, FS, jax_chain, port_chain, stereo_signal, worst_dbfs

from dsp_tpu_torch.core import prng
from dsp_tpu_torch.ops import fft_conv
from dsp_tpu_torch.ops import time_domain as td
from dsp_tpu_torch.ops.m4_engine import fma_ref

TILE = 128  # csrc/mod_delay.cu kTile
DTYPES = [torch.float64, torch.float32]


def _phase(t0, step, n, dtype):
    """The modulator's phase at samples n, as mod_delay_ref (float64) or
    mod_noise_f32_ref (float32) computes it."""
    n = torch.as_tensor(n, dtype=torch.float64)
    if dtype == torch.float64:
        return t0 + step * n
    return torch.tensor(t0, dtype=torch.float32) + (step * n).to(torch.float32)


def _tile_rows(t0, step, B, n0, dtype):
    """The knot rows the tile at sample n0 reads: [k_lo, k_hi + 4), the last
    tile's reaching the next window floor(t0 + step·B) + 4."""
    n1 = min(n0 + TILE, B)
    k_lo = int(torch.floor(_phase(t0, step, n0, dtype)))
    k_hi = int(torch.floor(_phase(t0, step, n1 - 1, dtype)))
    if n1 == B:
        if dtype == torch.float64:
            tb = t0 + step * B
        else:
            tb = float(torch.tensor(t0, dtype=torch.float32) + torch.tensor(step * B,
                                                                             dtype=torch.float32))
        k_hi = max(k_hi, math.floor(tb))
    return k_lo, k_hi + 4


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("fc,lanes,B", [(1.0, 2, 2048), (5000.0, 1, 1000), (900.0, 2, 65536)])
def test_tile_knots_equal_the_block_draw(fc, lanes, B, dtype):
    """Each tile's knots from its counters alone equal the rows of the
    whole block's draw (and the carried window's rows below 4), bit for
    bit; the whole draw equals the block's uniforms drawn at once."""
    rng = np.random.default_rng(int(fc) + B)
    key = prng.split(prng.prng_key(int(rng.integers(1 << 30))), 2)[1]
    step = 2.0 * fc / FS
    t0 = float(np.float32(rng.uniform(0, 1)))
    yk = torch.as_tensor(rng.standard_normal((4, lanes)) * 0.1).to(dtype)
    n_new = int(np.ceil(B * step)) + 1
    whole = torch.cat([yk, td.mod_knots_ref(key, torch.arange(n_new), lanes, dtype)])
    # the plain version's form before the tiles: the block's uniforms at once
    # (float64: summed in order, one FMA a term, as dsp_tpu's XLA:CPU sums)
    if dtype == torch.float64:
        u = prng.uniform_f64(key, (n_new, td.MOD_NOISE_N, 2, lanes), td.MOD_MAXVAL)
        d = u[:, :, 0] - u[:, :, 1]
        old = torch.zeros_like(d[:, 0])
        for j in range(td.MOD_NOISE_N):
            old = fma_ref(d[:, j], 0.77 / td.MOD_NOISE_N / td.MOD_MAXVAL, old)
    else:
        u = prng.uniform_f32(key, (n_new, td.MOD_NOISE_N, 2, lanes), td.MOD_MAXVAL)
        d = (u[:, :, 0] - u[:, :, 1]) * torch.tensor(0.77 / td.MOD_NOISE_N / td.MOD_MAXVAL,
                                                     dtype=torch.float32)
        old = torch.zeros_like(d[:, 0])
        for j in range(td.MOD_NOISE_N):
            old = old + d[:, j]
    assert torch.equal(whole[4:], old)
    spans = []
    for n0 in range(0, B, TILE):
        lo, hi = _tile_rows(t0, step, B, n0, dtype)
        assert 0 <= lo and hi <= 4 + n_new
        rows = torch.arange(lo, hi)
        new = rows[rows >= 4] - 4
        got = torch.cat([yk[rows[rows < 4]], td.mod_knots_ref(key, new, lanes, dtype)])
        assert torch.equal(got, whole[lo:hi])
        spans.append(hi - lo)
    # the kernel's bound on a tile's rows (ceil(step·128) + 6) holds
    assert max(spans) <= math.ceil(step * TILE) + 6


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("qual,mono", [(0, False), (2, True)])
def test_plain_version_returns_the_spliced_line(qual, mono, dtype):
    """mod_delay_ref's (and mod_delay_f32_ref's) carried line is
    splice_ref(buf, x, H, H - B, B), the effect's splice before, bit for
    bit, for B below, at and above H; the rest of the step is unchanged."""
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.delay import ModDelayEffect

    e = ModDelayEffect("delay", StreamInfo(FS, 2), np.ones(2, dtype=bool), 30.0, 900.0, mono,
                       qual, seed=555)
    H = e.len + e.n_taps
    rng = np.random.default_rng(qual)
    st = {k: torch.as_tensor(v) for k, v in e.state0().items()}
    st["buf"] = torch.as_tensor(rng.standard_normal((H, 2)) * 0.3)
    st = {k: v.to(dtype) if v.is_floating_point() else v for k, v in st.items()}
    table = None if e.table is None else torch.as_tensor(e.table).to(dtype)
    sel = torch.ones(2, dtype=torch.bool)
    ref = td.mod_delay_ref if dtype == torch.float64 else td.mod_delay_f32_ref
    for B in (H // 2, H, 3 * H):
        x = torch.as_tensor(rng.standard_normal((B, 2)) * 0.3).to(dtype)
        key, yk, t, y, buf = ref(st["key"], st["y"], st["t"], st["buf"], x, sel, table, e.depth,
                                 e.step_size, e.n_taps, qual)
        assert buf.dtype == dtype and tuple(buf.shape) == (H, 2)
        assert torch.equal(buf, fft_conv.splice_ref(st["buf"], x, H, H - B, B))
        st2, y2 = e.step(st, x)
        assert torch.equal(y2, y) and torch.equal(st2["buf"], buf)
        assert torch.equal(st2["key"], key) and torch.equal(st2["y"], yk)
        assert torch.equal(st2["t"], t)
        st = st2


@pytest.mark.parametrize("block", [64, 2048])
def test_modulated_chain_over_many_blocks_matches_dsp_tpu(block):
    """The modulated chain of test_modulated_chain_matches_dsp_tpu, and its
    delay alone with -m (a line of 154 rows), stepped block by block over
    0.2 s in blocks of 64 (shorter than the line) and 2048 (longer): each
    block's output within -280 dBFS of dsp_tpu, as that test holds the
    chain, and each block's carried line and key bit for bit."""
    for spec in ("delay -M 0.5m -q 2 10m noise -90 dither sloped2 16 stats levels",
                 "delay -m 0.5m -q 2 10m"):
        x = stereo_signal(0.2, seed=block)
        np.random.seed(99)
        t = port_chain(spec, block)
        np.random.seed(99)
        j = jax_chain(spec, block)
        n = x.shape[0] // block
        for b in range(n):
            xb = x[None, b * block:(b + 1) * block]
            y_t = t.run_blocks(xb).numpy()
            y_j = np.asarray(j.run_blocks(xb))
            assert y_t.shape == y_j.shape
            assert worst_dbfs(y_t, y_j) <= CHAIN_LIMIT_DBFS
            st_t = next(s for s in t.states if isinstance(s, dict) and "key" in s)
            st_j = next(s for s in j.states if isinstance(s, dict) and "key" in s)
            np.testing.assert_array_equal(st_t["buf"].numpy(), np.asarray(st_j["buf"]))
            np.testing.assert_array_equal(st_t["key"].numpy(), np.asarray(st_j["key"]))
