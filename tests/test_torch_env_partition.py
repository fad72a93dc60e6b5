"""A CPU model of how csrc/m4_env.cu (K11) partitions a block, held against
the plain versions m4_env_ref, m4_env_f32_ref, m4mb_env_ref and
m4mb_env_f32_ref, and at one shape against dsp_tpu's env_ewma_scan.

The kernel runs one launch over tiles of nseg segments of D = 32 samples
of all S lanes (m4_engine.env_partition).
A thread a (lane, segment) mixes its lane's pair by the frequency-mask
weights once a sample (m4_engine.band_mix_ref's order), forms the eight
envelope inputs once a sample and runs the eight EWMAs m' = a·m + g·s
(a = 1 - g) over its segment from zero: the segment's b. A scan over the
tile's segments, with a^(D·d) the multiplier, gives each segment's value
from the tile's start; the tile's start values come from a look-back that
always reaches tile 0: a^(nseg·D·t)·m_0 plus each earlier tile's aggregate
(its last segment's value from a zero start) times a^(nseg·D·distance),
in tile order, 32 tiles at a time, so the card's timing does not move a
bit. A segment's end is a tick: a^(D·(k+1))·start + b. The model does this
in float64 torch ops (the card fuses multiply-adds; the model does not,
and takes its powers from Python's pow, the card from CUDA's), so it
differs from the plain version by rounding only: 4e-15 absolute on the
ticks and the carried envelopes, in both dtypes (float32: hi + lo of the
carried pair).

Inputs are what the kernel is handed: seeded transient material (as
chip_smoke.py makes it) through matrix4's band-limit or matrix4_mb's bank
in their plain versions, seeded carried envelopes, the weights of
freq_mask = 0.5. No jax but in the one test that holds the model to
dsp_tpu.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from dsp_tpu_torch.ops import m4_engine as m4

ABS = 4e-15
WINDOW = 32  # tiles a look-back step examines (kLook in csrc/m4_env.cu)
FS = 44100
G = float(m4.ewma_g(FS, m4.ENV_SMOOTH_TIME))

def env_model(bands, env_m, g, w):
    """csrc/m4_env.cu's partition on bands [B, S, 2] from env_m [S, 8]:
    (env_m' [S, 8], env_ds [B / D, S, 8])."""
    B, S = bands.shape[:2]
    D = m4.DOWNSAMPLE_FACTOR
    nseg, ntiles = m4.env_partition(B, S)
    TS = nseg * D
    ana = bands if w is None else m4.band_mix_ref(bands, w)
    l, r = ana[..., 0], ana[..., 1]
    sum_, diff = l + r, l - r
    inp = torch.stack([l.abs(), r.abs(), sum_.abs(), diff.abs(),
                       l * l, r * r, sum_ * sum_, diff * diff], -1).reshape(B // D, D, S, 8)
    a = 1.0 - g
    b = torch.zeros(B // D, S, 8, dtype=torch.float64)
    for i in range(D):
        b = a * b + g * inp[:, i]
    ticks, agg = [], {}
    for t in range(ntiles):
        lanes = torch.zeros(nseg, S, 8, dtype=torch.float64)
        got = b[t * nseg:(t + 1) * nseg]
        lanes[:len(got)] = got
        d = 1
        while d < nseg:
            nxt = lanes.clone()
            nxt[d:] = a ** (D * d) * lanes[:-d] + lanes[d:]
            lanes, d = nxt, 2 * d
        if t < ntiles - 1:
            agg[t] = lanes[-1]
        start = (1.0 if t == 0 else a ** (TS * t)) * env_m
        for j0 in range(0, t, WINDOW):  # the look-back, in tile order
            for j in range(j0, min(t, j0 + WINDOW)):
                start = start + a ** (TS * (t - 1 - j)) * agg[j]
        k = torch.arange(1, nseg + 1, dtype=torch.float64)
        m = (a ** (D * k))[:, None, None] * start + lanes
        ticks.append(m[:len(got)])
    ticks = torch.cat(ticks)
    return ticks[-1], ticks


def transient_signal(n, seed):
    """chip_smoke.py's program material with transients: a quiet stereo
    bed (two tones and noise) and decaying noise bursts, one every
    0.15-0.45 s, panned left, right, centre, to the rear or between."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 0.02 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)], 1)
    x += 0.005 * rng.standard_normal((n, 2))
    pans = np.array([[1.0, 0.05], [0.05, 1.0], [0.7, 0.7], [0.7, -0.7], [1.0, 0.5], [-0.3, 1.0]])
    pos = int(0.01 * FS)
    while pos < n:
        m = min(n - pos, int(0.3 * FS))
        burst = rng.standard_normal(m) * np.exp(-np.arange(m) / (0.04 * FS)) * 0.3
        x[pos:pos + m] += burst[:, None] * pans[rng.integers(len(pans))]
        pos += int(rng.uniform(0.15, 0.45) * FS)
    return x


EFFECTS = {}


def _effect(words):
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    if words not in EFFECTS:
        effects = build_chain_from_string(words, StreamInfo(FS, 2)).effects
        EFFECTS[words] = next(e for e in effects if hasattr(e, "g_env"))
    return EFFECTS[words]


WARM = 2048


def _inputs(B, S, seed, dtype=torch.float64):
    """What the kernel is handed: seeded transient material after WARM
    samples through matrix4's band-limit (S = 1) or matrix4_mb's 13-band
    bank (S = 13), in the plain versions, and carried envelopes."""
    from dsp_tpu_torch.ops import iir

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(transient_signal(WARM + B, seed))
    if S == 1:
        e = _effect("matrix4 -6")
        A, Bv, c0 = (torch.as_tensor(getattr(e, k)) for k in ("A_bl", "B_bl", "c0_bl"))
        _, y = iir.biquad_scan_series(A, Bv, c0, torch.zeros(4, 2, dtype=torch.float64), x)
        bands = y[WARM:, None]
    else:
        e = _effect("matrix4_mb -6")
        plan = e._bank_plan(WARM + B)
        st = torch.zeros(2, plan.C, plan.n, dtype=torch.float64)
        _, y = iir.lti_blocked(plan, st, x.repeat(1, m4.N_BANDS))
        bands = y[WARM:].reshape(B, m4.N_BANDS, 2)
    env = torch.as_tensor(rng.uniform(0.0, 0.05, (S, 8)))
    return bands.contiguous().to(dtype), env.to(dtype)


# (S, w): matrix4's one lane; matrix4_mb's 13 bands without and with the
# frequency mask's mix
LANES = [(1, False), (13, False), (13, True)]
BLOCKS = [32, 2048, 65536, 1056]


@pytest.mark.parametrize("S,mixed", LANES)
@pytest.mark.parametrize("B", BLOCKS)
def test_partition_f64_matches_plain(S, mixed, B):
    bands, env = _inputs(B, S, 100 + B + S)
    w = torch.as_tensor(m4.band_mix_weights(0.5)) if mixed else None
    if S == 1:
        env_r, ds_r = m4.m4_env_ref(bands[:, 0], env[0], G)
        env_r, ds_r = env_r[None], ds_r[:, None]
    else:
        env_r, ds_r = m4.m4mb_env_ref(bands, env, G, w)
    env_m, ds_m = env_model(bands, env, G, w)
    err = max(float((env_m - env_r).abs().max()), float((ds_m - ds_r).abs().max()))
    assert err <= ABS, f"{err:.3e}"


@pytest.mark.parametrize("S,mixed", LANES)
@pytest.mark.parametrize("B", [2048, 1056])
def test_partition_f32_matches_plain(S, mixed, B):
    bands, env = _inputs(B, S, 300 + B + S)
    hi, env_hi = bands.float(), env.float()
    lo, env_lo = (bands - hi.double()).float(), (env - env_hi.double()).float()
    w = torch.as_tensor(m4.band_mix_weights(0.5)) if mixed else None
    if S == 1:
        e_hi, e_lo, ds_r = m4.m4_env_f32_ref(hi[:, 0], lo[:, 0], env_hi[0], env_lo[0], G)
        e_hi, e_lo, ds_r = e_hi[None], e_lo[None], ds_r[:, None]
    else:
        e_hi, e_lo, ds_r = m4.m4mb_env_f32_ref(hi, lo, env_hi, env_lo, G, w)
    env_m, ds_m = env_model(hi.double() + lo.double(), env_hi.double() + env_lo.double(), G, w)
    m_hi = env_m.float()
    m_lo = (env_m - m_hi.double()).float()
    assert float((ds_m - ds_r).abs().max()) <= ABS
    assert float(((m_hi.double() + m_lo.double()) - (e_hi.double() + e_lo.double())).abs().max()) <= ABS


@pytest.mark.parametrize("S,mixed", LANES)
def test_partition_against_extended_precision(S, mixed):
    """The partition against the EWMAs run sample by sample in extended
    precision (np.longdouble), at B = 65536: within 4e-16, a tenth of the
    tolerance against the plain version, whose doubling scan is the less
    accurate of the two (2e-15 from this run on these inputs)."""
    B = 65536
    bands, env = _inputs(B, S, 500 + S)
    w = torch.as_tensor(m4.band_mix_weights(0.5)) if mixed else None
    ana = (bands if w is None else m4.band_mix_ref(bands, w)).numpy().astype(np.longdouble)
    l, r = ana[..., 0], ana[..., 1]
    inp = np.stack([abs(l), abs(r), abs(l + r), abs(l - r),
                    l * l, r * r, (l + r) ** 2, (l - r) ** 2], -1)
    g = np.longdouble(G)
    m, ticks = env.numpy().astype(np.longdouble), []
    for t in range(B):
        m = (1 - g) * m + g * inp[t]
        if t % m4.DOWNSAMPLE_FACTOR == m4.DOWNSAMPLE_FACTOR - 1:
            ticks.append(m)
    env_m, ds_m = env_model(bands, env, G, w)
    assert np.abs(ds_m.numpy() - np.stack(ticks)).max() <= 4e-16
    assert np.abs(env_m.numpy() - m).max() <= 4e-16


def test_partition_matches_dsp_tpu():
    """The model against dsp_tpu's env_ewma_scan (its associative scan of
    the affine maps, jax on the CPU) on one lane at B = 2048."""
    import jax
    import jax.numpy as jnp

    import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
    from dsp_tpu.ops import m4_engine as jm4

    bands, env = _inputs(2048, 1, 7)
    x = bands[:, 0].numpy()
    sum_, diff = x[:, 0] + x[:, 1], x[:, 0] - x[:, 1]
    env_in = np.stack([np.abs(x[:, 0]), np.abs(x[:, 1]), np.abs(sum_), np.abs(diff),
                       x[:, 0] ** 2, x[:, 1] ** 2, sum_ ** 2, diff ** 2], 1)
    last, _, envs = jax.jit(lambda m, v: jm4.env_ewma_scan(m, None, G, v, False))(
        jnp.asarray(env[0].numpy()), jnp.asarray(env_in))
    env_m, ds_m = env_model(bands, env, G, None)
    assert np.abs(env_m[0].numpy() - np.asarray(last)).max() <= ABS
    assert np.abs(ds_m[:, 0].numpy() - np.asarray(envs)[31::32]).max() <= ABS


def test_partition_shapes():
    """A tile is nseg segments of D samples of every lane (8 for one lane
    and 4 for 13, or 32 for one lane at B >= 16384 and 8 for 13 above
    B = 8192); the tiles cover the block."""
    D = m4.DOWNSAMPLE_FACTOR
    for S in (1, 13):
        for B in BLOCKS:
            nseg, ntiles = m4.env_partition(B, S)
            assert nseg == ((32 if B >= 16384 else 8) if S == 1 else (8 if B > 8192 else 4))
            assert (ntiles - 1) * nseg * D < B <= ntiles * nseg * D
