"""How csrc/levels.cu (K17) cuts a block into tiles, on the CPU, against the
plain version and dsp_tpu.

The kernel runs a block in one launch: tiles of 256 samples (of up to 8
channels), each lane of a warp a segment of 8 samples composed into one
max-affine map m -> max(c, a·m + b) (avg takes its affine part); a warp
scan gives each segment its map from the tile's start; each tile publishes
its map, and csrc/lookback.cuh's carry_max_affine applies every earlier
tile's map to the carried (avg, m), in tile order (a value carried, never a
composed map); each lane reruns its segment from its start value, and the
block's peak is the largest m of every tile and the carried one (exact in
any order). levels_model below is that partition in float64 tensors with
the kernel's FMAs (fma_ref), its float32 form reading float32 and rounding
each meter once.

Held: levels_step_ref within 1e-12 relative (float32: levels_step_f32_ref
within one float32 ulp) at tc 0.01 and 10, on noise, silence and a click
after silence (the max branch), at B = 1, 1000, 2048 and 65,536; and at one
shape against dsp_tpu's LevelsEffect.step.
"""

import math

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from dsp_tpu_torch.ops import time_domain as td
from dsp_tpu_torch.ops.m4_engine import fma_ref

TILE, SEG = 256, 8  # csrc/levels.cu kTile, kSeg
FS = 44100


def _fma(a, b, c):
    """fma_ref where a·b + c is finite; the IEEE result elsewhere (the
    identity map's -inf)."""
    plain = a * b + c
    return torch.where(torch.isfinite(plain), fma_ref(a, b, c), plain)


def _compose(f, s):
    """`s` after `f`, as the kernel's compose."""
    return (s[0] * f[0], _fma(s[0], f[1], s[1]), torch.fmax(s[2], _fma(s[0], f[2], s[1])))


def levels_model(avg, peak, block_peak, xs, g):
    """The kernel's partition in float64: (avg', peak', block_peak') [n]."""
    f64 = torch.float64
    B, n = xs.shape
    ntiles = -(-B // TILE)
    x = torch.zeros((ntiles * TILE, n), dtype=f64)
    x[:B] = xs.to(f64)
    valid = torch.zeros(ntiles * TILE, dtype=torch.bool)
    valid[:B] = True
    x = x.view(ntiles, 32, SEG, n)
    valid = valid.view(ntiles, 32, SEG)[..., None].expand(-1, -1, -1, n)
    a = 1.0 - g
    one = torch.ones((ntiles, 32, n), dtype=f64)
    ident = (one, torch.zeros_like(one), torch.full_like(one, -math.inf))
    # each lane's segment as one map
    f = ident
    for i in range(SEG):
        s = x[:, :, i] * x[:, :, i]
        step = (torch.full_like(s, a), g * s, s)
        h = _compose(f, step)
        f = tuple(torch.where(valid[:, :, i], hv, fv) for hv, fv in zip(h, f))
    # the warp's Kogge-Stone scan over the lanes
    for d in (1, 2, 4, 8, 16):
        o = tuple(torch.cat([v[:, :d], v[:, :-d]], dim=1) for v in f)
        h = _compose(o, f)
        lane = torch.arange(32)[None, :, None] >= d
        f = tuple(torch.where(lane, hv, fv) for hv, fv in zip(h, f))
    pre = tuple(torch.cat([iv[:, :1], v[:, :-1]], dim=1) for v, iv in zip(f, ident))
    tile_map = tuple(v[:, 31] for v in f)  # [ntiles, n]
    # the carried value through the tiles' maps in tile order
    starts = []
    u, m = avg.to(f64).clone(), peak.to(f64).clone()
    for t in range(ntiles):
        starts.append((u, m))
        A, Bm, C = (v[t] for v in tile_map)
        u, m = _fma(A, u, Bm), torch.fmax(C, _fma(A, m, Bm))
    su = torch.stack([s[0] for s in starts])[:, None, :]
    sm = torch.stack([s[1] for s in starts])[:, None, :]
    # each segment from its start, rerun
    uu = _fma(pre[0], su, pre[1])
    mm = torch.fmax(pre[2], _fma(pre[0], sm, pre[1]))
    bp = torch.zeros_like(uu)
    for i in range(SEG):
        s = x[:, :, i] * x[:, :, i]
        gs = g * s
        u2 = _fma(torch.full_like(s, a), uu, gs)
        m2 = torch.fmax(s, _fma(torch.full_like(s, a), mm, gs))
        ok = valid[:, :, i]
        uu, mm = torch.where(ok, u2, uu), torch.where(ok, m2, mm)
        bp = torch.where(ok, torch.fmax(bp, mm), bp)
    block = torch.fmax(block_peak.to(f64), bp.amax(dim=(0, 1)))
    return uu[-1, 31], mm[-1, 31], block


def levels_model_f32(avg, peak, block_peak, xs, g):
    return tuple(t.to(torch.float32) for t in levels_model(avg, peak, block_peak, xs, g))


def _signal(kind, B, rng):
    if kind == "noise":
        return rng.standard_normal((B, 2)) * 0.3
    x = np.zeros((B, 2))
    if kind == "click":
        x[min(B - 1, B // 2 + 3), 0] = 0.9
        x[B - 1, 1] = -0.5
    return x


def _ulps32(a, b):
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


# every signal and time constant at B = 1, 1000 and 2048; noise at B = 65,536
CASES = [(B, kind, tc) for B in (1, 1000, 2048) for kind in ("noise", "silence", "click")
         for tc in (0.01, 10.0)] + [(65536, "noise", 0.01)]


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("B,kind,tc", CASES)
def test_model_matches_plain_version(B, kind, tc, f32):
    rng = np.random.default_rng(B)
    g = 1.0 - np.exp(-1.0 / (FS * tc))
    dt = torch.float32 if f32 else torch.float64
    st = [torch.as_tensor(rng.uniform(0, 0.1, 2)).to(dt) for _ in range(3)]
    if kind != "noise":
        st = [torch.zeros(2, dtype=dt) for _ in range(3)]
    for _ in range(2):  # two blocks: the second from the first's state
        xs = torch.as_tensor(_signal(kind, B, rng)).to(dt)
        if f32:
            got = levels_model_f32(*st, xs, g)
            want = td.levels_step_f32_ref(*st, xs, g)
            for a, b in zip(got, want):
                assert _ulps32(a, b) <= 1
        else:
            got = levels_model(*st, xs, g)
            want = td.levels_step_ref(*st, xs, g)
            for a, b in zip(got, want):
                assert float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1e-300)
        st = list(want)


def test_click_after_silence_takes_the_max_branch():
    """After silence the peak meter jumps to the click's square at once
    (m' = max(s, ...)) and block_peak holds it."""
    x = np.zeros((2048, 2))
    x[1500, 0] = 0.5
    z = torch.zeros(2, dtype=torch.float64)
    avg, peak, bp = levels_model(z, z, z, torch.as_tensor(x), 1.0 - np.exp(-1.0 / (FS * 0.3)))
    assert float(bp[0]) == 0.25 and float(bp[1]) == 0.0
    assert 0.0 < float(peak[0]) < 0.25 and float(avg[0]) < float(peak[0])


def test_against_dsp_tpu_levels_step():
    """The model against dsp_tpu's LevelsEffect.step (an associative scan)
    over three blocks of 2048, within 1e-12 relative."""
    import jax.numpy as jnp

    import dsp_tpu  # noqa: F401  (its config turns on jax's float64)
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.levels import LevelsEffect as JLevels

    j = JLevels("levels", JStream(FS, 2), np.ones(2, dtype=bool), 0.3)
    st_j = {k: jnp.asarray(v) for k, v in j.state0().items()}
    st = [torch.zeros(2, dtype=torch.float64) for _ in range(3)]
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = rng.standard_normal((2048, 2)) * 0.3
        st = levels_model(*st, torch.as_tensor(x), j.g)
        st_j, _ = j.step(st_j, jnp.asarray(x))
        for a, k in zip(st, ("avg", "peak", "block_peak")):
            np.testing.assert_allclose(a.numpy(), np.asarray(st_j[k]), rtol=1e-12, atol=0)
