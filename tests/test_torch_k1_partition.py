"""A CPU model of how csrc/lti_blocked.cu (K1, K1-df) partitions a block,
held against the plain versions lti_blocked_ref and lti_blocked_f32_ref.

The kernel runs one launch: a block of B samples is cut into chunks of Lk
samples (the plan's L, or iir.K1_SUB_L for an L = 1 plan, whose tables it
rebuilds at that length from the same system; the last chunk may then be
short) and the chunks into tiles of T chunks, a thread block each
(iir.lti_partition). A tile composes the carry from its start over its
chunks, u_i = sum over i' <= i of AL^(i-i')·v_i' (AL = A^Lk), by a
Kogge-Stone scan (u_i += AL^d·u_{i-d}, d = 1, 2, 4, ...), and publishes
u_{T-1}, its aggregate; every tile takes its start state from a look-back
that always reaches tile 0, s_in = Qt[t]·s_0 + sum over j < t of
Qt[t-1-j]·u_{T-1}(j) (Qt[m] = AL^(T·m), the tile powers), summed in tile
order 32 tiles at a time, so the card's timing does not move a bit. Each
chunk's start state is then s_i = AL^i·s_in + u_{i-1}, and y = c0·x +
W·x + P·s_i. The model does the kernel's operations in its grouping in
float64 torch ops (the card fuses multiply-adds and splits its sums over
lanes; the model does not), under the partition's own tile size and under
one chunk a tile and the largest tile, so against the plain version it
differs by rounding only: 1e-15 absolute in float64 (y and the end state),
and in float32 y within one float32 ulp of its scale and the (hi, lo)
state's sum within 1e-13 relative (chip_smoke.py's F32_STATE_REL).

The host tables (iir.lti_kernel_tables) are held against
numpy.linalg.matrix_power, in extended precision, of the matrix the plain
version steps with, a channel at a time.
Systems: the flagship chain's fused cascade (C = 2, n = 12) and
matrix4_mb's 13-band bank (C = 26, n = 40). No jax: the plain version is
the reference here.
"""

import math

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from dsp_tpu_torch.ops import iir

FLAGSHIP = ("gain -3 eq 1k 1.0 +3 eq 3.5k 0.8 -2 lowshelf 90 0.7071s +4 highshelf 10k 0.7071s -2 "
            "lowpass 18k 0.7071 highpass 30 0.7071 crossfeed 700 4.5 st2ms ms2st")
F64_ABS = 1e-15
F32_STATE_REL = 1e-13
WINDOW = 32  # tiles a look-back step examines (kLook in csrc/lti_blocked.cu)


def _flagship_plan(L):
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.biquad import BiquadEffect

    chain = build_chain_from_string(FLAGSHIP, StreamInfo(44100, 2))
    return iir.CascadeBlockedPlan([e.c for e in chain.effects if type(e) is BiquadEffect], L=L)


def _bank_plan(L):
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.matrix4_mb import Matrix4MbEffect

    chain = build_chain_from_string("matrix4_mb -6", StreamInfo(44100, 2))
    e = next(e for e in chain.effects if isinstance(e, Matrix4MbEffect))
    return iir.CascadeBlockedPlan.from_ss(iir.ss_stack(e._band_systems()), L=L)


PLANS = {}


def plan_of(system, L):
    if (system, L) not in PLANS:
        PLANS[system, L] = {"flagship": _flagship_plan, "bank": _bank_plan}[system](L)
    return PLANS[system, L]


def _mv(M, v):
    return torch.einsum("cij,cj->ci", M, v)


def k1_model(plan, state, x, T=None):
    """csrc/lti_blocked.cu's partition in float64 torch ops, tiles of T
    chunks (the partition's own unless given): (state' [2, C, n], y [B, C])."""
    B, C = x.shape
    Lk, T, Nc, ntiles, tail = iir.lti_partition(plan, B, T)
    h, V, P, Qc, Qt, At, c0 = (None if a is None else torch.as_tensor(a)
                               for a in iir.lti_kernel_tables(plan, B, T))
    chunk = plan if Lk == plan.L else plan._sub_plan
    W = torch.as_tensor(chunk.W)
    xp = torch.zeros(Nc * Lk, C, dtype=torch.float64)
    xp[:B] = x
    xc = xp.reshape(Nc, Lk, C)
    lens = [Lk] * (Nc - 1) + [tail]
    v = [torch.einsum("crj,jc->cr", V[:, :, Lk - lens[k]:], xc[k, :lens[k]]) for k in range(Nc)]
    s0 = state[0] + state[1]
    agg, y = {}, torch.empty(Nc, Lk, C, dtype=torch.float64)
    for t in range(ntiles):
        k0, last = t * T, t == ntiles - 1
        nch = min(T, Nc - k0)
        partial = last and tail < Lk
        nfull = nch - 1 if partial else nch
        # the carry from the tile's start: a Kogge-Stone scan over its whole
        # chunks, u_i += AL^d·u_{i-d}
        u = [v[k0 + i] for i in range(nch)]
        d = 1
        while d < nfull:
            u = u[:d] + [u[i] + _mv(Qc[:, d], u[i - d]) for i in range(d, nfull)] + u[nfull:]
            d *= 2
        if not last:
            agg[t] = u[T - 1]
        sin = s0
        if t > 0:  # the look-back, in tile order, WINDOW tiles at a time
            sin = _mv(Qt[:, t], s0)
            for j0 in range(0, t, WINDOW):
                terms = [_mv(Qt[:, t - 1 - j], agg[j]) for j in range(j0, min(t, j0 + WINDOW))]
                for term in terms:
                    sin = sin + term
        ss = [sin] + [_mv(Qc[:, i], sin) + u[i - 1] for i in range(1, nch)]
        if last:
            end = _mv(At if partial else Qc[:, 1], ss[-1]) + v[k0 + nch - 1]
        for i in range(nch):
            y[k0 + i] = (c0 * xc[k0 + i] + torch.einsum("clk,ck->lc", P, ss[i])
                         + torch.einsum("cij,jc->ic", W, xc[k0 + i]))
    return torch.stack([end, torch.zeros_like(end)]), y.reshape(-1, C)[:B]


def _inputs(plan, B, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((B, plan.C)) * 0.3)
    st = torch.as_tensor(rng.standard_normal((2, plan.C, plan.n)) * 1e-2)
    st[1] *= 1e-9  # a small lo part, as a state handed over from dsp_tpu may carry
    return x.to(dtype), st.to(dtype)


# (system, L, B): Nc = 1, 16, 17 and 512 at L = 128; the L = 1 plans at
# B = 1056 (33 chunks of 32) and 1000 (a short last chunk of 8)
CASES = [("flagship", 128, 128), ("flagship", 128, 2048), ("flagship", 128, 2176),
         ("flagship", 128, 65536), ("flagship", 1, 1056), ("flagship", 1, 1000),
         ("bank", 128, 128), ("bank", 128, 2048), ("bank", 128, 2176), ("bank", 128, 65536),
         ("bank", 1, 1056), ("bank", 1, 1000)]


def _tilings(plan, B):
    """The partition's own tile size, the most a tile holds and (up to 64
    chunks over the channels) one chunk a tile, where they differ: each
    another set of tile powers and look-back windows over the same
    function."""
    Lk, T, Nc, _, _ = iir.lti_partition(plan, B)
    most = min(iir.K1_TILE_SAMPLES // Lk, iir.K1_POWER_DOUBLES // plan.n ** 2)
    return sorted({T, min(Nc, most)} | ({1} if Nc * plan.C <= 64 else set()))


@pytest.mark.parametrize("system,L,B", CASES)
def test_partition_f64_matches_plain(system, L, B):
    plan = plan_of(system, L)
    x, st = _inputs(plan, B, 1000 + B)
    s_r, y_r = iir.lti_blocked_ref(plan, st, x)
    for T in _tilings(plan, B):
        s_m, y_m = k1_model(plan, st, x, T)
        err = max(float((y_m - y_r).abs().max()), float((s_m - s_r).abs().max()))
        assert err <= F64_ABS, f"T={T}: {err:.3e}"


def _ulps(got, want):
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    return err / 2.0 ** (math.floor(math.log2(scale)) - 23)


@pytest.mark.parametrize("system,L,B,df", [("flagship", 128, 2048, False),
                                           ("flagship", 128, 65536, False),
                                           ("bank", 128, 2048, True), ("bank", 1, 1056, True),
                                           ("flagship", 1, 1000, True)])
def test_partition_f32_matches_plain(system, L, B, df):
    plan = plan_of(system, L)
    x, st = _inputs(plan, B, 2000 + B, torch.float32)
    s_r, y_r = iir.lti_blocked_f32_ref(plan, st, x, df)
    s_m, y_m = k1_model(plan, st.double(), x.double())
    s_m = torch.stack(iir.split_f64(s_m[0]))
    y_hi, y_lo = iir.split_f64(y_m)
    got = y_hi.double() + y_lo.double() if df else y_hi
    want = y_r[0].double() + y_r[1].double() if df else y_r
    assert _ulps(got, want) <= 1.0
    rel = float(((s_m[0].double() + s_m[1].double()) - (s_r[0].double() + s_r[1].double()))
                .abs().max()) / float((s_r[0].double() + s_r[1].double()).abs().max())
    assert rel <= F32_STATE_REL


@pytest.mark.parametrize("system,L,B", [("flagship", 128, 2048), ("flagship", 128, 65536),
                                        ("bank", 128, 2048), ("bank", 1, 1056),
                                        ("flagship", 1, 1000)])
def test_kernel_tables_are_matrix_powers(system, L, B):
    """Against numpy.linalg.matrix_power, in extended precision, of the
    matrix the plain version steps with (the plan's AL = A^L at L = 128,
    its A at L = 1): the chunk powers Qc and At, computed in extended
    precision and rounded once, within 1e-15 relative of each power's
    largest entry; the tile powers Qt, float64 products of the rounded
    AL^T (up to 63 factors here), within 1e-14 (the partition tests show
    that their rounding moves no output). Against float64 matrix_power of
    the plan's A itself (whose own rounding reaches 1e-12 at these
    exponents) every table agrees within 1e-11 relative: each is the power
    of A it is meant to be."""
    plan = plan_of(system, L)
    Lk, T, Nc, ntiles, tail = iir.lti_partition(plan, B)
    h, V, P, Qc, Qt, At, c0 = iir.lti_kernel_tables(plan, B)
    assert Qc.shape == (plan.C, T + 1, plan.n, plan.n)
    assert Qt.shape == (plan.C, ntiles, plan.n, plan.n)
    assert (At is None) == (tail == Lk)
    G, step = (plan.AL, 1) if L == Lk else (plan.A, Lk)
    pairs = ([(Qc[:, i], step * i, Lk * i, 1e-15) for i in range(T + 1)]
             + [(Qt[:, m], step * T * m, Lk * T * m, 1e-14) for m in range(ntiles)])
    for c in range(plan.C):
        for got, k, k_a, rel in pairs + ([(At, tail, tail, 1e-15)] if At is not None else []):
            want = np.linalg.matrix_power(G[c].astype(np.longdouble), k)
            scale = max(float(np.abs(want).max()), 1e-300)
            assert float(np.abs(got[c] - want).max()) <= rel * scale, (c, k)
            want64 = np.linalg.matrix_power(plan.A[c], k_a)
            assert np.abs(got[c] - want64).max() <= 1e-11 * scale, (c, k_a)
    # the chunk tables are the blocked plan's at Lk (an L = 1 plan's system
    # rebuilt at K1_SUB_L), its A^Lk the chunk transition
    chunk = plan if Lk == plan.L else plan._sub_plan
    assert chunk.L == Lk and np.abs(chunk.AL - Qc[:, 1]).max() <= 1e-15 * np.abs(Qc[:, 1]).max()
    assert np.array_equal(c0, plan.c0) and h.shape == (plan.C, Lk) and V.shape[2] == Lk


def test_partition_shapes():
    """The tiles cover the block: about K1_BLOCKS blocks, at most
    K1_TILE_SAMPLES samples and K1_POWER_DOUBLES of chunk powers a tile,
    Lk = L or K1_SUB_L."""
    for system, L, B in CASES:
        plan = plan_of(system, L)
        Lk, T, Nc, ntiles, tail = iir.lti_partition(plan, B)
        assert Lk == (L if L > 1 else iir.K1_SUB_L)
        assert (Nc - 1) * Lk + tail == B and 0 < tail <= Lk
        assert (ntiles - 1) * T < Nc <= ntiles * T and T * Lk <= iir.K1_TILE_SAMPLES
        # the fewest chunks a tile that make at most about K1_BLOCKS blocks,
        # within the caps on samples and chunk powers a tile
        most = min(iir.K1_TILE_SAMPLES // Lk, iir.K1_POWER_DOUBLES // plan.n ** 2)
        assert T == max(1, min(most, -(-Nc * plan.C // iir.K1_BLOCKS)))
        assert T == 1 or T * plan.n ** 2 <= iir.K1_POWER_DOUBLES
