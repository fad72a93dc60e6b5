"""The resampler's step (K8) as csrc/resample.cu runs it in one launch, and
the routes the resampler takes, on the CPU.

The kernel gives output columns b = g·m .. g·m + m - 1 of channel c to
thread block (g, c), a lane each (m from the card's SM count): the block
transforms those inner blocks, folds, inverts and stores y = head_b +
tail_(b-1), each times 1/N and the ratio, lane t taking lane t - 1's tail.
The blocks of a channel run in clusters of up to K_MAX along g: a
block hands its last lane's scaled tail to its successor's shared memory,
the first block of every cluster but the first recomputes its
predecessor's column, column 0 takes the carried overlap, the last
column's tail is the overlap carried out, and blocks past the last column
(the grid is whole clusters) only meet the barriers. `step_model` runs
that partition with the plain version's column values and must equal
resample_step_ref / resample_step_f32_ref bit for bit: the same values,
moved by the partition. Tolerances and why:

* the model, the float64 overlap-add store (irfft_ola_ref against the
  parent route's torch ops written out) and the routes' compositions:
  equal (the same operations on the same values);
* resample_step_ref against dsp_tpu's SpectralResampler.block over two
  carried steps: -280 dBFS, tests/test_torch_resample.py's step limit
  (both sum the same products; pocketfft and XLA round the transforms
  differently);
* resample_step_f32_ref against dsp_tpu's float32 step (_block_df, its
  two-float32 DFTs): one float32 ulp of the output's scale (measured 0.36
  at 44.1 to 48 kHz). The port rounds a float64 head plus a float32 tail
  once; dsp_tpu rounds its head to float32 and then the sum.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import CHAIN_LIMIT_DBFS, worst_dbfs

from dsp_tpu_torch.ops import fft_conv as fc
from dsp_tpu_torch.ops import resample_ops as ro

# the rate pairs the repo runs: (in_fs, out_fs)
PAIRS = [(44100, 48000), (44100, 192000), (48000, 44100), (44100, 88200), (96000, 44100)]
INNER_BLOCKS = (1, 4, 9, 112)
# the kernel's cluster size (csrc/resample.cu kMaxCluster); the model also
# takes clusters of 1 (every block recomputes its predecessor) and 3
K_MAX = int(re.search(r"constexpr int kMaxCluster = (\d+);",
                      (Path(ro.__file__).parent.parent / "csrc" / "resample.cu").read_text())[1])
CLUSTERS = (1, 3, K_MAX)
LANES = (1, 2, 5)


def _rs(pair):
    return ro.SpectralResampler(*pair)


def _inputs(rs, n, C, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((n * rs.in_len, C)) * 0.3, dtype=dtype)
    ov = torch.as_tensor(rng.standard_normal((rs.out_len, C)) * 0.1, dtype=dtype)
    return ov, x


def lane_values(rs, x):
    """What each lane's transforms leave in shared memory, scaled by 1/N and
    the ratio: column b·C + c of the plain version's inverse [2 out_len,
    n·C]."""
    n = x.shape[0] // rs.in_len
    if x.dtype == torch.float32:
        X = fc.rfft_pack_f32_ref(x, 2 * rs.in_len, blocks=n)
    else:
        X = fc.rfft_pack_ref(x[:0], x, 2 * rs.in_len, blocks=n)
    Ni = 2 * rs.out_len
    return fc.irfft_crop_ref(ro.resample_fold_ref(X, rs.fold), Ni, 0, Ni) * (rs.out_len / rs.in_len)


def step_model(v, overlap, cluster, m):
    """csrc/resample.cu's resample_step_kernel partition, m inner blocks a
    thread block, on lane_values v: (overlap', y)."""
    f32 = overlap.dtype == torch.float32
    half, C = overlap.shape
    n = v.shape[1] // C

    def tail(b):  # ola_tail: rounded to the sample type
        t = v[half:, b * C:(b + 1) * C]
        return t.float() if f32 else t

    groups = -(-n // m)
    K = min(cluster, groups)
    grid = -(-groups // K) * K
    prev = [None] * grid  # each block's `prev` (its lane 0's) in shared memory
    writes = [0] * grid
    for g in range(min(grid, groups)):  # before the barrier: a block's own prev
        if g == 0:
            prev[g], writes[g] = overlap.clone(), writes[g] + 1
        elif g % K == 0:  # a cluster's first block recomputes column g·m - 1
            prev[g], writes[g] = tail(g * m - 1), writes[g] + 1
    for g in range(grid):  # the hand-off into the successor's shared memory
        if g * m < n and g % K + 1 < K and g * m + m < n:
            prev[g + 1], writes[g + 1] = tail(g * m + m - 1), writes[g + 1] + 1
    assert writes[:groups] == [1] * groups and not any(writes[groups:]), writes
    y = torch.full((n * half, C), math.nan, dtype=overlap.dtype)
    ov_out = None
    for g in range(groups):  # after the cluster's barrier: the stores
        lanes = min(m, n - g * m)
        for t in range(lanes):
            b = g * m + t
            p = prev[g] if t == 0 else tail(b - 1)  # lane t - 1 of the same block
            head = v[:half, b * C:(b + 1) * C]
            y[b * half:(b + 1) * half] = (head + p.double()).float() if f32 else head + p
        if g * m + lanes == n:
            assert ov_out is None
            ov_out = tail(n - 1).contiguous()
    return ov_out, y


@pytest.mark.parametrize("n", INNER_BLOCKS)
@pytest.mark.parametrize("pair", PAIRS)
def test_partition_model_equals_the_plain_step(pair, n):
    """The one-launch partition (column ownership, the cluster edges, b = 0
    from the carried overlap, the last column's tail) on mono, stereo and 6
    channels, both dtypes, with 1, 2 and 5 inner blocks a thread block (the
    last block partial where m does not divide n), under clusters of 1
    (every block recomputes its predecessor), 3 and K_MAX: bit for
    bit the plain step."""
    rs = _rs(pair)
    for C in (1, 2, 6):
        for dtype, ref in ((torch.float64, ro.resample_step_ref),
                           (torch.float32, ro.resample_step_f32_ref)):
            ov, x = _inputs(rs, n, C, dtype, seed=n * 10 + C)
            ov_r, y_r = ref(rs, ov, x)
            assert y_r.shape == (n * rs.out_len, C) and y_r.dtype == ov_r.dtype == dtype
            v = lane_values(rs, x)
            for K in CLUSTERS:
                for m in LANES:
                    ov_m, y_m = step_model(v, ov, K, m)
                    assert torch.equal(y_m, y_r), (pair, n, C, dtype, K, m)
                    assert torch.equal(ov_m, ov_r), (pair, n, C, dtype, K, m)


@pytest.mark.parametrize("pair", PAIRS)
def test_the_repos_rate_pairs_take_one_launch(pair):
    """Both transforms one block pass and a column's two lanes and float64
    tail within a thread block's shared memory."""
    rs = _rs(pair)
    assert rs.route == ro.ONE_LAUNCH
    for N in (2 * rs.in_len, 2 * rs.out_len):
        (p,) = fc.fft_plan(N, 1).passes
        assert p.kind == "block" and p.T == 1
    smem = 16 * (fc.lane_points(2 * rs.in_len) + fc.lane_points(2 * rs.out_len)) + 8 * rs.out_len
    assert smem <= fc.SMEM_LIMIT


def test_a_prime_pass_takes_three_launches():
    """resample 44101 at 44.1 kHz: its inverse at N = 88,202 has a global
    pass of the prime 44,101, so its step is rfft_pack, resample_fold and
    irfft_ola."""
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.resample import resample_effect_init

    e = resample_effect_init(None, StreamInfo(44100, 2), None, None, ["resample", "44101"])
    rs = e.rs
    assert (rs.in_len, rs.out_len) == (44100, 44101) and rs.route == ro.THREE_LAUNCHES
    assert [p.kind for p in fc.fft_plan(2 * rs.out_len, 1).passes][-1] == "global"
    assert ro.step_route(6, 8193) == ro.THREE_LAUNCHES  # an inverse past one block pass


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_three_launch_route_composes_the_plain_step(dtype):
    """The route of three launches, composed of its wrappers' plain
    versions, is the plain step."""
    rs = _rs((44100, 48000))
    dt = getattr(torch, dtype)
    ov, x = _inputs(rs, 3, 2, dt, seed=7)
    ratio = rs.out_len / rs.in_len
    if dt == torch.float32:
        X = fc.rfft_pack_f32_ref(x, 2 * rs.in_len, blocks=3)
        want = ro.irfft_ola_f32_ref(ro.resample_fold_ref(X, rs.fold), 2 * rs.out_len, ov, ratio)
        got = ro.resample_step_f32_ref(rs, ov, x)
    else:
        X = fc.rfft_pack_ref(x[:0], x, 2 * rs.in_len, blocks=3)
        want = ro.irfft_ola_ref(ro.resample_fold_ref(X, rs.fold), 2 * rs.out_len, ov, ratio)
        got = ro.resample_step_ref(rs, ov, x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # on CPU tensors the wrappers run their plain versions
    for a, b in zip(rs.block(ov, x), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 4])
def test_float64_ola_ref_is_the_parent_formula(n):
    """irfft_ola_ref against the float64 step's torch ops as they stood
    before the store (irfft_crop, times the ratio, the carried overlap and
    the tails concatenated, the shifted add), bit for bit."""
    rs = _rs((44100, 48000))
    rng = np.random.default_rng(n)
    C, N = 2, 2 * rs.out_len
    Y = torch.as_tensor(rng.standard_normal((N // 2 + 1, n * C))
                        + 1j * rng.standard_normal((N // 2 + 1, n * C)))
    ov = torch.as_tensor(rng.standard_normal((N // 2, C)))
    ratio = rs.out_len / rs.in_len
    y2 = (fc.irfft_crop_ref(Y, N, 0, N) * ratio).reshape(2, rs.out_len, n, C)
    head, tail = y2[0], y2[1]
    prev = torch.cat([ov[:, None], tail[:, :-1]], dim=1)
    y_want = (head + prev).permute(1, 0, 2).reshape(n * rs.out_len, C)
    ov_got, y_got = ro.irfft_ola(Y, N, ov, ratio)
    assert torch.equal(y_got, y_want) and torch.equal(ov_got, tail[:, -1])
    with pytest.raises(TypeError, match="the kernel takes"):
        ro.irfft_ola_f32(Y, N, ov, ratio)
    with pytest.raises(TypeError, match="the kernel takes"):
        ro.irfft_ola(Y, N, ov.float(), ratio)


@pytest.mark.parametrize("pair", [(44100, 48000), (44100, 192000)])
def test_plain_step_matches_dsp_tpu_float64(pair):
    """resample_step_ref over two carried steps of 2 inner blocks against
    dsp_tpu's block, one inner block at a time."""
    import jax.numpy as jnp
    from dsp_tpu.ops.resample_ops import SpectralResampler as J

    rs, j = _rs(pair), J(*pair)
    ov, x = _inputs(rs, 4, 2, torch.float64, seed=3)
    ov_t, ys = ov, []
    for k in range(2):
        ov_t, y = ro.resample_step_ref(rs, ov_t, x[k * 2 * rs.in_len:(k + 1) * 2 * rs.in_len])
        ys.append(y)
    ov_j, yj = jnp.asarray(ov.numpy()), []
    for i in range(4):
        ov_j, y = j.block(ov_j, jnp.asarray(x[i * rs.in_len:(i + 1) * rs.in_len].numpy()))
        yj.append(np.asarray(y))
    assert worst_dbfs(torch.cat(ys).numpy(), np.concatenate(yj)) <= CHAIN_LIMIT_DBFS
    assert worst_dbfs(ov_t.numpy(), np.asarray(ov_j)) <= CHAIN_LIMIT_DBFS


def test_plain_step_matches_dsp_tpu_float32():
    """resample_step_f32_ref over two carried steps of 2 inner blocks
    against dsp_tpu's float32 step (_block_df), one inner block at a time,
    at 44.1 to 48 kHz: within one float32 ulp of the output's scale."""
    import jax.numpy as jnp
    from dsp_tpu.ops.resample_ops import SpectralResampler as J

    pair = (44100, 48000)
    rs, j = _rs(pair), J(*pair)
    ov, x = _inputs(rs, 4, 2, torch.float32, seed=4)
    ov_t, ys = ov, []
    for k in range(2):
        ov_t, y = ro.resample_step_f32_ref(rs, ov_t, x[k * 2 * rs.in_len:(k + 1) * 2 * rs.in_len])
        ys.append(y)
    ov_j, yj = jnp.asarray(ov.numpy()), []
    for i in range(4):
        ov_j, y = j.block(ov_j, jnp.asarray(x[i * rs.in_len:(i + 1) * rs.in_len].numpy()))
        yj.append(np.asarray(y))
    want = np.concatenate(yj)
    assert want.dtype == np.float32
    ulp = float(np.abs(want).max()) * 2.0 ** -23
    np.testing.assert_allclose(torch.cat(ys).numpy(), want, rtol=0, atol=ulp)
    np.testing.assert_allclose(ov_t.numpy(), np.asarray(ov_j), rtol=0, atol=ulp)


def test_step_refuses_a_partial_inner_block():
    rs = _rs((44100, 48000))
    ov, x = _inputs(rs, 2, 2, torch.float64, seed=5)
    with pytest.raises(ValueError, match="not a multiple of 588"):
        ro.resample_step(rs, ov, x[:-1])
    with pytest.raises(TypeError, match="the kernel takes"):
        ro.resample_step_f32(rs, ov.float(), x)
    with pytest.raises(TypeError, match="the kernel takes"):
        ro.resample_step_f32(rs, ov, x.float())


def test_step_settles_the_overlaps_dtype():
    """The float64 step converts a carried overlap of another float dtype
    (as dsp_tpu's block does) before it picks a route, so every route
    takes float64; the float32 step takes a float32 overlap only."""
    rs = _rs((44100, 48000))
    ov, x = _inputs(rs, 2, 2, torch.float64, seed=8)
    ov32 = ov.float()
    for a, b in zip(ro.resample_step(rs, ov32, x), ro.resample_step_ref(rs, ov32.double(), x)):
        assert a.dtype == torch.float64 and torch.equal(a, b)
    with pytest.raises(TypeError, match="the kernel takes"):
        ro.resample_step_f32(rs, ov.half(), x.float())


def test_noise_effect_builds_its_selector_once():
    """NoiseEffect hands tpdf_noise a selector made at its first block on a
    device and reused after, and None when every channel is selected; its
    noise equals the plain version's with that selector."""
    from dsp_tpu_torch.core.prng import prng_key
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.noise import NoiseEffect
    from dsp_tpu_torch.ops import time_domain as td

    x = torch.as_tensor(np.random.default_rng(6).standard_normal((1000, 3)))
    key = prng_key(11)
    sel = np.array([True, False, True])
    part = NoiseEffect("noise", StreamInfo(44100, 3), sel, 1e-3)
    k1, y1 = part.step(key, x)
    (held,) = part._sel.values()
    k2, y2 = part.step(k1, x)
    assert part._sel[x.device] is held and torch.equal(held, torch.as_tensor(sel))
    kr, yr = td.tpdf_noise_ref(key, x, 1e-3, torch.as_tensor(sel))
    assert torch.equal(k1, kr) and torch.equal(y1, yr)
    assert torch.equal(y2, td.tpdf_noise_ref(k1, x, 1e-3, torch.as_tensor(sel))[1])
    every = NoiseEffect("noise", StreamInfo(44100, 3), np.ones(3, dtype=bool), 1e-3)
    assert torch.equal(every.step(key, x)[1], td.tpdf_noise_ref(key, x, 1e-3)[1])
    assert not every._sel
