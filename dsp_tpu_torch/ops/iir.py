"""IIR recurrences: host plan algebra, the K1/K2 kernel wrappers and their
plain PyTorch versions.

A TDF2 biquad with normalized coefficients (c0..c4) is the 2-state linear
recurrence (biquad.c:296-315, biquad.h:76-92)

    s[n] = A s[n-1] + B x[n],   y[n] = c0 x[n] + s[n-1][0]

    A = [[-c3, 1], [-c4, 0]],   B = [c1 - c3 c0,  c2 - c4 c0]

These kernels run the recurrences on the device:

* K1, ``lti_blocked``: an n-state LTI system (a fused cascade of biquads, or
  one biquad) over B = Nc·L samples, in chunks of L = 128 (or L = 1, a
  sample a step), from a ``CascadeBlockedPlan``'s host-precomputed tables.
  The kernel runs a call in one launch, tiles of chunks over the card
  (``lti_partition``, ``lti_kernel_tables``; an L = 1 plan in chunks of
  32). On float32 samples it is ``lti_blocked_f32`` (K1-df), which also
  gives ``lti_blocked_df``'s (hi, lo) output.
* K2, ``biquad_scan``: per-lane biquads over any B >= 1, with any 2x2 A,
  in float64, or in float32 throughout (``biquad_scan_f32``).
* K3, ``biquad_scan_df``: K2 on float32 samples with float64 coefficients
  and a [2, C, 2] float32 (hi, lo) state; ``biquad_scan_auto`` picks it
  under float32.
* K2 in the launches the chain makes with it: ``biquad_scan_pair`` (a
  float64 (hi, lo) state read and written in the kernel),
  ``biquad_scan_series`` (matrix4's band-limit, two stages in one launch)
  and ``crossfeed_step`` / ``crossfeed_step_f32`` (crossfeed's lanes and
  mix in one launch).
* A run of stages in series, K2 or K3 in one launch: ``biquad_scan_run``
  (float64) and ``biquad_scan_run_df`` (float32 samples), each stage's
  state single or a (hi, lo) pair, read and written where its owner keeps
  it: the chain's runs of adjacent per-sample biquads
  (``effects/biquad.BiquadRun``) and matrix4_mb's fshape and its inverse.

dsp_tpu runs its float32 forms of K1 and K3 in two-float32 (hi, lo)
arithmetic, because the TPU has no usable float64. Hopper has float64 in
hardware, so the port's float32 forms read float32 samples, carry every
product and sum in float64 and store float32: y rounded once, and a state
s split as hi = float32(s), lo = float32(s - hi). That computes the same
function at least as accurately from the plan's float64 tables, with none
of dsp_tpu's hi/lo table splits or df carry; its outputs are not dsp_tpu
float32's bit for bit.

The stream axis (split and batched processing, ``CompiledChain.
process_array_split`` and ``process_batch``): K1, K2 (``biquad_scan``,
``biquad_scan_f32``, ``biquad_scan_pair``), K3 (``biquad_scan_df``),
crossfeed's step and the runs take x as [S, B, C] as well as [B, C], S
independent streams, each state then with a leading S ([S, 2, C, n],
[S, C, 2], [S, 2, C, 2], [S, 4, 2]). The streams share the coefficients
and tables (indexed by channel, never tiled into S copies), and a CUDA
tensor runs all S streams in the one launch of S = 1; each plain version
loops over the streams, so that stream s is the bits of a one-stream call.

Each wrapper checks the dtypes it takes, then dispatches on the tensor's
device only: a CPU tensor runs the plain version (``*_ref``), a CUDA
tensor launches the CUDA kernel (``dsp_tpu_torch/csrc/``) or raises. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.

The host algebra (``_coupled_form_ss``, ``ss_*``, the plans) is numpy
float64, as in dsp_tpu/ops/iir.py, so both packages build the same tables
from the same coefficients. States keep dsp_tpu's [2, C, n] (hi, lo)
layout (lo = 0 in float64), so a state passes between the packages
unchanged.
"""

import numpy as np
import torch

from dsp_tpu_torch.ops.fft_conv import _check_dtypes, each_stream

# chunk length of the blocked kernel; block sizes must be multiples of this
# (and >= 2*BLOCKED_L) to take the blocked path (see BiquadEffect.step and
# chain.CompiledChain._fuse)
BLOCKED_L = 128


def biquad_coeffs_to_ss(c, dtype=np.float64):
    """c: array [5, C] (c0..c4, already normalized by a0) -> companion-form
    (A [C,2,2], Bv [C,2], c0 [C]), numpy, computed in `dtype` (float32 as
    dsp_tpu's float32 callers cast the coefficients first)."""
    c = np.asarray(c, dtype=dtype)
    c0, c1, c2, c3, c4 = c
    A = np.zeros((c.shape[1], 2, 2), dtype=dtype)
    A[:, 0, 0] = -c3
    A[:, 0, 1] = 1.0
    A[:, 1, 0] = -c4
    Bv = np.stack([c1 - c3 * c0, c2 - c4 * c0], axis=-1)
    return A, Bv, c0.copy()


def make_identity_biquad(channels, dtype=np.float64):
    """Coefficient array [5, C] for a unit passthrough."""
    c = np.zeros((5, channels), dtype=dtype)
    c[0] = 1.0
    return c


def _coupled_form_ss(c):
    """Host-side state-space (A [C,2,2], Bv [C,2]) with y = c0 x + s[n-1][0].

    For complex-pole channels the companion form is similarity-transformed to
    the coupled (rotation) form A = r*R(theta): companion matrix powers of a
    near-DC resonator are non-normal and transiently grow to ~1/sin(theta)
    (~100 for `highpass 30`), so the P/V tables hold large entries whose
    products cancel. Coupled-form powers stay bounded by r^k <= 1. The
    transform T = [[1, 0], [a1/2, im]] keeps the output row e0 T = [1, 0], so
    y = c0 x + s[0] holds in both bases and states are interchangeable with
    zeros-initialized use. Real-pole channels keep the companion form (their
    transient growth is bounded for audio filters). numpy float64 only.
    """
    c = np.asarray(c, dtype=np.float64)
    C = c.shape[1]
    c0, c1, c2, c3, c4 = c
    A = np.zeros((C, 2, 2))
    A[:, 0, 0] = -c3
    A[:, 0, 1] = 1.0
    A[:, 1, 0] = -c4
    Bv = np.stack([c1 - c3 * c0, c2 - c4 * c0], axis=-1)  # [C, 2]
    disc = c3 * c3 - 4.0 * c4
    cplx = disc < 0.0
    if np.any(cplx):
        re = -c3 / 2.0
        im = np.sqrt(np.maximum(-disc, 0.0)) / 2.0
        im_safe = np.where(cplx, im, 1.0)
        Ac = np.zeros((C, 2, 2))
        Ac[:, 0, 0] = re
        Ac[:, 0, 1] = im
        Ac[:, 1, 0] = -im
        Ac[:, 1, 1] = re
        # T^-1 = [[1, 0], [-a1/(2 im), 1/im]]
        Bc = np.stack(
            [Bv[:, 0], (-c3 / (2.0 * im_safe)) * Bv[:, 0] + Bv[:, 1] / im_safe],
            axis=-1,
        )
        A = np.where(cplx[:, None, None], Ac, A)
        Bv = np.where(cplx[:, None], Bc, Bv)
    return A, Bv


# --- host-side state-space algebra (numpy float64, per-channel batched) ----
#
# Systems are dicts {A: [C,n,n], B: [C,n], C: [C,n], D: [C]} with the
# observer timing y[n] = D x[n] + C s[n-1], s[n] = A s[n-1] + B x[n].


def ss_identity(channels):
    return {
        "A": np.zeros((channels, 0, 0)),
        "B": np.zeros((channels, 0)),
        "C": np.zeros((channels, 0)),
        "D": np.ones(channels),
    }


def ss_from_biquad(c):
    """[5, C] normalized biquad -> coupled-form state-space dict."""
    c = np.asarray(c, dtype=np.float64)
    A, B = _coupled_form_ss(c)
    C = A.shape[0]
    Crow = np.zeros((C, 2))
    Crow[:, 0] = 1.0  # coupled basis keeps the output row at [1, 0]
    return {"A": A, "B": B, "C": Crow, "D": c[0].copy()}


def ss_series(s1, s2):
    """s2 after s1 (audio flows s1 -> s2)."""
    A1, B1, C1, D1 = s1["A"], s1["B"], s1["C"], s1["D"]
    A2, B2, C2, D2 = s2["A"], s2["B"], s2["C"], s2["D"]
    Cch, n1 = A1.shape[0], A1.shape[1]
    n2 = A2.shape[1]
    A = np.zeros((Cch, n1 + n2, n1 + n2))
    A[:, :n1, :n1] = A1
    A[:, n1:, :n1] = np.einsum("ci,cj->cij", B2, C1)
    A[:, n1:, n1:] = A2
    B = np.concatenate([B1, B2 * D1[:, None]], axis=1)
    C = np.concatenate([C1 * D2[:, None], C2], axis=1)
    D = D2 * D1
    return {"A": A, "B": B, "C": C, "D": D}


def ss_add(s1, s2, g1=1.0, g2=1.0):
    """Parallel sum g1*s1 + g2*s2 (same input feeds both)."""
    A1, B1, C1, D1 = s1["A"], s1["B"], s1["C"], s1["D"]
    A2, B2, C2, D2 = s2["A"], s2["B"], s2["C"], s2["D"]
    Cch, n1 = A1.shape[0], A1.shape[1]
    n2 = A2.shape[1]
    A = np.zeros((Cch, n1 + n2, n1 + n2))
    A[:, :n1, :n1] = A1
    A[:, n1:, n1:] = A2
    B = np.concatenate([B1, B2], axis=1)
    C = np.concatenate([C1 * g1, C2 * g2], axis=1)
    D = g1 * D1 + g2 * D2
    return {"A": A, "B": B, "C": C, "D": D}


def ss_scale(s, g):
    """Output gain g applied to a system."""
    return {"A": s["A"], "B": s["B"], "C": s["C"] * g, "D": s["D"] * g}


def ss_stack(systems):
    """Stack systems along the channel axis (pad state dims to the max)."""
    nmax = max(s["A"].shape[1] for s in systems)
    As, Bs, Cs, Ds = [], [], [], []
    for s in systems:
        Cch, n = s["A"].shape[0], s["A"].shape[1]
        A = np.zeros((Cch, nmax, nmax))
        A[:, :n, :n] = s["A"]
        B = np.zeros((Cch, nmax))
        B[:, :n] = s["B"]
        C = np.zeros((Cch, nmax))
        C[:, :n] = s["C"]
        As.append(A)
        Bs.append(B)
        Cs.append(C)
        Ds.append(s["D"])
    return {
        "A": np.concatenate(As, axis=0),
        "B": np.concatenate(Bs, axis=0),
        "C": np.concatenate(Cs, axis=0),
        "D": np.concatenate(Ds, axis=0),
    }


class CascadeBlockedPlan:
    """Blocked-kernel plan for a SERIES of biquads fused into one LTI system.

    Composing K cascaded biquads host-side into one 2K-state system

        s[n] = A s[n-1] + B x[n],   y[n] = D x[n] + C s[n-1]

    (series connection: A = [[A1, 0], [B2 C1, A2]], B = [B1; B2 D1],
    C = [D2 C1, C2], D = D2 D1, per channel, each stage in the coupled
    basis) gives ONE kernel launch with one within-chunk impulse response
    and a single 2K-dim carry chain. Used only as an execution-time fusion
    (chain.CompiledChain) so the user-visible chain and plot output stay
    identical to the reference.

    Tables (numpy float64, per channel): ``h`` [C, L] impulse response taps
    (h[:, k] = C A^k B for k < L-1, last entry 0), ``W`` [C, L, L] the
    chunk's causal Toeplitz matrix built from h (used by the plain version
    only; the kernel works from h), ``P`` [C, L, n], ``V`` [C, n, L],
    ``AL`` = A^L [C, n, n] and ``c0`` = D [C]; and the system itself, ``A``,
    ``B_in`` and ``C_out``, from which ``kernel_tables`` builds what
    csrc/lti_blocked.cu takes besides (lti_kernel_tables).
    """

    def __init__(self, cs, L=BLOCKED_L):
        """cs: list of [5, C] normalized coefficient arrays, stage order."""
        cs = [np.asarray(c, dtype=np.float64) for c in cs]
        sys = ss_from_biquad(cs[0])
        for c in cs[1:]:
            sys = ss_series(sys, ss_from_biquad(c))
        self._init_from_ss(sys, L)

    @classmethod
    def from_ss(cls, sys, L=BLOCKED_L):
        """Build a plan from a host state-space dict (see ss_from_biquad)."""
        self = cls.__new__(cls)
        self._init_from_ss(sys, L)
        return self

    def _init_from_ss(self, sys, L):
        A, B, Crow, D = sys["A"], sys["B"], sys["C"], sys["D"]
        C = A.shape[0]
        n = A.shape[1]
        self.L = L
        self.C = C
        self.n = n
        dt = A.dtype  # float64; np.longdouble for the kernel's L = 1 tables
        pows = np.zeros((L + 1, C, n, n), dtype=dt)
        pows[0] = np.eye(n)[None]
        for k in range(1, L + 1):
            pows[k] = np.einsum("cij,cjk->cik", A, pows[k - 1])
        # composite impulse response h[k] = C A^(k-1) B (k >= 1); h[0] = D
        h = np.einsum("ci,kcij,cj->kc", Crow, pows[: L - 1], B)  # h[1..L-1]
        self.h = np.zeros((C, L), dtype=dt)
        self.h[:, : L - 1] = h.T
        W = np.zeros((C, L, L), dtype=dt)
        for i in range(1, L):
            for j in range(i):
                W[:, i, j] = h[i - 1 - j]
        self.W = W
        self.P = np.einsum("ci,kcij->ckj", Crow, pows[:L])  # [C, L, n]
        self.V = np.stack(
            [np.einsum("cij,cj->ci", pows[L - 1 - j], B) for j in range(L)], axis=2
        )  # [C, n, L]
        self.AL = pows[L]
        self.c0 = D
        self.A, self.B_in, self.C_out = A, B, Crow
        self._device_tables = {}

    def table(self, name, device, dtype=torch.float64):
        """Table `name` ("h", "W", "V", "P", "AL" or "c0") as a contiguous
        tensor on `device` (cached per device and dtype)."""
        key = (name, torch.device(device), dtype)
        t = self._device_tables.get(key)
        if t is None:
            t = torch.as_tensor(np.ascontiguousarray(getattr(self, name)), dtype=dtype,
                                device=device)
            self._device_tables[key] = t
        return t

    def kernel_tables(self, B, device):
        """The tables csrc/lti_blocked.cu takes for a block of B samples on
        `device` (see lti_kernel_tables), cached per block size and device."""
        key = ("k1", B, torch.device(device))
        t = self._device_tables.get(key)
        if t is None:
            t = tuple(None if a is None else torch.as_tensor(np.ascontiguousarray(a), device=device)
                      for a in lti_kernel_tables(self, B))
            self._device_tables[key] = t
        return t


class BiquadBlockedPlan(CascadeBlockedPlan):
    """A one-stage cascade: the blocked plan of a single biquad."""

    def __init__(self, c, L=BLOCKED_L):
        super().__init__([c], L)


# --- K1: blocked LTI filter -------------------------------------------------

# csrc/lti_blocked.cu's partition: the blocks a launch aims at (a tile of
# chunks a block), the samples a tile holds at most, the doubles of chunk
# powers a tile holds at most (they sit in shared memory), and the chunk
# length it runs an L = 1 plan at
K1_BLOCKS = 128
K1_TILE_SAMPLES = 2048
K1_POWER_DOUBLES = 13000
K1_SUB_L = 32


def lti_partition(plan, B, T=None):
    """How csrc/lti_blocked.cu cuts a block of B samples for `plan`:
    (Lk, T, Nc, ntiles, tail): chunks of Lk samples (the plan's L, or
    K1_SUB_L for an L = 1 plan), Nc chunks of which the last holds `tail`
    samples, tiles of T chunks (a thread block each; about K1_BLOCKS blocks
    over the channels, at most K1_TILE_SAMPLES samples and K1_POWER_DOUBLES
    of chunk powers a tile, unless T is given)."""
    Lk = plan.L if plan.L >= K1_SUB_L else K1_SUB_L
    Nc = -(-B // Lk)
    if T is None:
        most = min(K1_TILE_SAMPLES // Lk, K1_POWER_DOUBLES // (plan.n * plan.n))
        T = max(1, min(most, -(-Nc * plan.C // K1_BLOCKS)))
    return Lk, T, Nc, -(-Nc // T), B - (Nc - 1) * Lk


def lti_kernel_tables(plan, B, T=None):
    """csrc/lti_blocked.cu's float64 tables for a block of B samples (numpy):
    (h, V, P, Qc, Qt, At, c0) at the partition's chunk length Lk. G is the
    matrix the plain version steps with (the plan's AL = A^L, or an L = 1
    plan's A) and AL = G^(Lk/L) the chunk transition: Qc [C, T+1, n, n] =
    AL^i for i = 0..T, Qt [C, ntiles, n, n] = AL^(T·m) for m =
    0..ntiles-1, the tile powers, and At [C, n, n] = A^tail when the last
    chunk is short (else None). h, V, P and c0 are the plan's own; an L = 1
    plan's are rebuilt at Lk from its system. The chunk powers and At (the
    state's path from chunk to chunk) are computed in extended precision
    (np.longdouble) and rounded once, so the kernel's composition adds
    little rounding to the plain version's steps; the tile powers, whose
    rounding moves no output (tests/test_torch_k1_partition.py), are
    float64 products of the rounded AL^T, so a block of many tiles costs
    milliseconds on the host, not a second."""
    Lk, T, _, ntiles, tail = lti_partition(plan, B, T)
    mp = np.linalg.matrix_power
    if Lk == plan.L:
        G, step, chunk = plan.AL.astype(np.longdouble), 1, plan
    else:
        G, step = plan.A.astype(np.longdouble), Lk
        chunk = plan.__dict__.get("_sub_plan")
        if chunk is None:
            chunk = plan._sub_plan = _sub_plan(plan, Lk)
    G_L, eye = mp(G, step), np.broadcast_to(np.eye(plan.n, dtype=G.dtype), G.shape)
    Qc = [eye]
    for _ in range(T):
        Qc.append(G_L @ Qc[-1])
    G_tile = Qc[T].astype(np.float64)
    Qt = [np.broadcast_to(np.eye(plan.n), G_tile.shape)]
    for _ in range(1, ntiles):
        Qt.append(G_tile @ Qt[-1])
    At = mp(G, tail).astype(np.float64) if tail < Lk else None
    return (chunk.h, chunk.V, chunk.P, np.stack(Qc, axis=1).astype(np.float64),
            np.stack(Qt, axis=1), At, chunk.c0)


def _sub_plan(plan, L):
    """An L = 1 plan's system as a blocked plan at chunk length L, its
    tables computed in extended precision and rounded once."""
    ld = {k: np.asarray(v, dtype=np.longdouble)
          for k, v in (("A", plan.A), ("B", plan.B_in), ("C", plan.C_out), ("D", plan.c0))}
    sub = CascadeBlockedPlan.from_ss(ld, L=L)
    for k in ("h", "W", "P", "V", "AL"):
        setattr(sub, k, getattr(sub, k).astype(np.float64))
    sub.A, sub.B_in, sub.C_out, sub.c0 = plan.A, plan.B_in, plan.C_out, plan.c0
    return sub


def lti_blocked(plan, state, x):
    """Run a block through a CascadeBlockedPlan (K1).

    state: [2, C, n] (hi, lo); x: [B, C] with B a multiple of plan.L, both
    float64, or both float32 (then this is lti_blocked_f32). Returns
    (state' [2, C, n] with lo = 0 in float64, y [B, C]). With a stream
    axis, x [S, B, C] and state [S, 2, C, n]: the S streams share the
    plan's tables and the partition of one stream, in one launch. CPU
    tensors run lti_blocked_ref; CUDA tensors launch csrc/lti_blocked.cu."""
    if x.dtype == torch.float32:
        return lti_blocked_f32(plan, state, x)
    _check_dtypes("lti_blocked", (x, torch.float64), (state, torch.float64))
    if x.device.type == "cpu":
        return lti_blocked_ref(plan, state, x)
    return _launch_lti_blocked(lti_blocked, plan, state, x, False)


lti_blocked.launches = 0


def lti_blocked_f32(plan, state, x, df_out=False):
    """K1-df: lti_blocked on float32 x [B, C] and a float32 (hi, lo)
    state [2, C, n], carried in float64 from the plan's float64 tables.
    Returns (state', y), with the state split into (hi, lo); with df_out,
    (state', (y_hi, y_lo)), y split the same way. CPU tensors run
    lti_blocked_f32_ref; CUDA tensors launch csrc/lti_blocked.cu."""
    _check_dtypes("lti_blocked_f32", (x, torch.float32), (state, torch.float32))
    if x.device.type == "cpu":
        return lti_blocked_f32_ref(plan, state, x, df_out)
    return _launch_lti_blocked(lti_blocked_f32, plan, state, x, df_out)


lti_blocked_f32.launches = 0


def lti_blocked_df(plan, state, x):
    """dsp_tpu's lti_blocked_df (iir.py:556): lti_blocked with the output
    as a (hi, lo) pair, for consumers that read it better than float32.
    Returns (state', (y_hi, y_lo)); under float64 y_lo is zeros."""
    if x.dtype == torch.float32:
        return lti_blocked_f32(plan, state, x, df_out=True)
    state, y = lti_blocked(plan, state, x)
    return state, (y, torch.zeros_like(y))


def _launch_lti_blocked(wrapper, plan, state, x, df_out):
    from dsp_tpu_torch import kernels

    S, B, C = _check_cuda(wrapper.__name__, x, state)
    L, n = plan.L, plan.n
    if C != plan.C or B % L:
        raise ValueError(f"{wrapper.__name__}: x {tuple(x.shape)} does not fit a plan of "
                         f"C={plan.C}, L={L}")
    want = (*x.shape[:-2], 2, C, n)
    if tuple(state.shape) != want:
        raise ValueError(f"{wrapper.__name__}: state {tuple(state.shape)}, expected {want}")
    # the partition of one stream at any S: a stream's tiles and their
    # sums are those of a one-stream call
    Lk, T, _, ntiles, _ = lti_partition(plan, B)
    y = torch.empty_like(x)
    y_lo = torch.empty_like(x) if df_out else None
    state_out = torch.empty_like(state)
    kernels.launch_lti_blocked(x, y, state, state_out, plan.kernel_tables(B, x.device),
                               kernels.lookback_scratch(x, ntiles * S * C, n), Lk, T, S, y_lo)
    wrapper.launches += 1
    return state_out, ((y, y_lo) if df_out else y)


def lti_blocked_ref(plan, state, x):
    """Plain PyTorch version of K1 (any device): einsums for the chunk
    products, a loop over the Nc chunks for the carry. With a stream axis,
    x [S, B, C] and state [S, 2, C, n] a stream at a time."""
    if x.dim() == 3:
        return each_stream(lambda st, xs: lti_blocked_ref(plan, st, xs), state, x)
    B, C = x.shape
    L = plan.L
    Nc = B // L
    W, V, P, AL, c0 = (plan.table(k, x.device, x.dtype) for k in ("W", "V", "P", "AL", "c0"))
    xc = x.reshape(Nc, L, C)
    z = torch.einsum("cij,njc->nic", W, xc)
    v = torch.einsum("cij,njc->nci", V, xc)  # [Nc, C, n]
    s = state[0] + state[1]
    s_start = []
    for k in range(Nc):
        s_start.append(s)
        s = torch.einsum("cij,cj->ci", AL, s) + v[k]
    s_start = torch.stack(s_start)
    y = c0 * xc + torch.einsum("clk,nck->nlc", P, s_start) + z
    return torch.stack([s, torch.zeros_like(s)]), y.reshape(B, C)


def lti_blocked_f32_ref(plan, state, x, df_out=False):
    """Plain PyTorch version of K1-df: lti_blocked_ref in float64 on the
    upcast x and state (hi + lo), then the state and y split to float32."""
    st, y = lti_blocked_ref(plan, state.double(), x.double())
    y_hi, y_lo = split_f64(y)
    return torch.stack(split_f64(st[..., 0, :, :]), dim=-3), ((y_hi, y_lo) if df_out else y_hi)


def split_f64(v):
    """float64 tensor -> its float32 (hi, lo) pair: hi = float32(v),
    lo = float32(v - hi), so hi + lo holds v to ~48 bits."""
    hi = v.float()
    return hi, (v - hi.double()).float()


# --- K2 and K3: per-lane biquad scans ----------------------------------------


def biquad_scan(A, Bv, c0, state, x):
    """Run one block of per-lane biquads (K2).

    A [C,2,2], Bv [C,2], c0 [C]; state [C,2] (TDF2 memories); x [B,C]; all
    float64, or all float32 (then this is biquad_scan_f32). Returns
    (state' [C,2], y [B,C]); with a stream axis x [S,B,C] and state
    [S,C,2]. CPU tensors run biquad_scan_ref; CUDA tensors launch
    csrc/biquad_scan.cu."""
    if x.dtype == torch.float32:
        return biquad_scan_f32(A, Bv, c0, state, x)
    _check_dtypes("biquad_scan", *[(t, torch.float64) for t in (x, state, A, Bv, c0)])
    if x.device.type == "cpu":
        return biquad_scan_ref(A, Bv, c0, state, x)
    return _launch_biquad_scan(biquad_scan, A, Bv, c0, state, x, False)


biquad_scan.launches = 0


def biquad_scan_f32(A, Bv, c0, state, x):
    """K2 in float32: coefficients, state, samples and every product and
    sum in float32, as dsp_tpu's float32 scan (crossfeed, the Thiran
    delay). CPU tensors run biquad_scan_f32_ref; CUDA tensors launch
    csrc/biquad_scan.cu."""
    _check_dtypes("biquad_scan_f32", *[(t, torch.float32) for t in (x, state, A, Bv, c0)])
    if x.device.type == "cpu":
        return biquad_scan_f32_ref(A, Bv, c0, state, x)
    return _launch_biquad_scan(biquad_scan_f32, A, Bv, c0, state, x, False)


biquad_scan_f32.launches = 0


def biquad_scan_df(A, Bv, c0, state, x):
    """K3, dsp_tpu's biquad_scan_df (iir.py:89): the per-sample biquad on
    float32 x [B, C] with float64 A [C,2,2], Bv [C,2] and c0 [C] (the
    coupled form) and a float32 (hi, lo) state [2, C, 2], so that it hands
    a state to and from K1-df, or a single float32 state [C, 2] (as
    biquad_scan_auto hands it). Returns (state' of the state's shape,
    y [B, C] float32); with a stream axis x [S, B, C] and the state
    [S, 2, C, 2] or [S, C, 2]. CPU tensors run biquad_scan_df_ref; CUDA
    tensors launch csrc/biquad_scan.cu."""
    _check_dtypes("biquad_scan_df", (x, torch.float32), (state, torch.float32),
                  *[(t, torch.float64) for t in (A, Bv, c0)])
    if x.device.type == "cpu":
        return biquad_scan_df_ref(A, Bv, c0, state, x)
    return _launch_biquad_scan(biquad_scan_df, A, Bv, c0, state, x, _is_pair(state, x))


biquad_scan_df.launches = 0


def biquad_scan_pair(A, Bv, c0, state, x):
    """K2 on a float64 (hi, lo) state [2, C, 2], as BiquadEffect's
    per-sample path keeps it: the state read as hi + lo, the end state
    returned as (s, 0), in the kernel's one launch. A [C,2,2], Bv [C,2],
    c0 [C], x [B,C], all float64. Returns (state' [2,C,2], y [B,C]); with a
    stream axis x [S,B,C] and state [S,2,C,2]. CPU tensors run
    biquad_scan_pair_ref; CUDA tensors launch csrc/biquad_scan.cu
    (dsp_biquad_scan_f64_pair)."""
    _check_dtypes("biquad_scan_pair", *[(t, torch.float64) for t in (x, state, A, Bv, c0)])
    if x.device.type == "cpu":
        return biquad_scan_pair_ref(A, Bv, c0, state, x)
    return _launch_biquad_scan(biquad_scan_pair, A, Bv, c0, state, x, True)


biquad_scan_pair.launches = 0


def biquad_scan_pair_ref(A, Bv, c0, state, x):
    """Plain PyTorch version of biquad_scan_pair: K2's on hi + lo, the end
    state stacked over zeros; x [S, B, C] and state [S, 2, C, 2] a stream
    at a time."""
    if x.dim() == 3:
        return each_stream(lambda st, xs: biquad_scan_pair_ref(A, Bv, c0, st, xs), state, x)
    s_end, y = biquad_scan_ref(A, Bv, c0, state[0] + state[1], x)
    return torch.stack([s_end, torch.zeros_like(s_end)]), y


def biquad_scan_series(A, Bv, c0, state, x):
    """Two stages of per-lane biquads in series, in one launch: matrix4's
    band-limit (the highpass, then the lowpass, dsp_tpu's two
    biquad_scan calls and the states' concatenation). A [2C,2,2], Bv
    [2C,2], c0 [2C] and state [2C,2], rows [0, C) the first stage; x
    [B,C]; all float64. Returns (state' [2C,2], y [B,C] the second stage's
    output); with a stream axis x [S,B,C] and state [S,2C,2], S·C lanes in
    one launch. CPU tensors run biquad_scan_series_ref; CUDA tensors launch
    csrc/biquad_scan.cu (dsp_biquad_scan_series_f64)."""
    _check_dtypes("biquad_scan_series", *[(t, torch.float64) for t in (x, state, A, Bv, c0)])
    if x.device.type == "cpu":
        return biquad_scan_series_ref(A, Bv, c0, state, x)
    from dsp_tpu_torch import kernels

    S, B, C = _check_cuda("biquad_scan_series", x, state, A, Bv, c0)
    _check_shapes("biquad_scan_series", A, Bv, c0, state, 2 * C, x.shape[:-2])
    y = torch.empty_like(x)
    state_out = torch.empty_like(state)
    kernels.launch_biquad_scan_series(A, Bv, c0, state, state_out, x, y, S)
    biquad_scan_series.launches += 1
    return state_out, y


biquad_scan_series.launches = 0


def biquad_scan_series_ref(A, Bv, c0, state, x):
    """Plain PyTorch version of biquad_scan_series: biquad_scan_ref twice
    and the states' concatenation; x [S, B, C] and state [S, 2C, 2] a
    stream at a time."""
    if x.dim() == 3:
        return each_stream(lambda st, xs: biquad_scan_series_ref(A, Bv, c0, st, xs), state, x)
    C = x.shape[1]
    st1, y1 = biquad_scan_ref(A[:C], Bv[:C], c0[:C], state[:C], x)
    st2, y2 = biquad_scan_ref(A[C:], Bv[C:], c0[C:], state[C:], y1)
    return torch.cat([st1, st2]), y2


def biquad_scan_run(A, Bv, c0, states, x, out=None):
    """A run of n stages of per-lane biquads in series, in one launch: stage
    s runs A[s] [C,2,2], Bv[s] [C,2] and c0[s] [C] (float64 A [n,C,2,2], Bv
    [n,C,2], c0 [n,C]) from states[s] on stage s - 1's output (stage 0 on x
    [B, C]), as n separate biquad_scan (a [C, 2] state) or biquad_scan_pair
    (a [2, C, 2] (hi, lo) state) calls would; under float32 x this is
    biquad_scan_run_df. The n states share one layout and may be views with
    other strides (matrix4_mb's inv_fshape_m[:, s]); each lane's two values
    must be adjacent. out: n tensors of that layout the end states are
    written into, or None: views of one new [n, *state shape] tensor.
    Returns (the n end states, y [B, C] the last stage's output). With a
    stream axis, x [S, B, C] and each state [S, C, 2] or [S, 2, C, 2]. CPU
    tensors run biquad_scan_run_ref; CUDA tensors launch csrc/biquad_scan.cu
    (dsp_biquad_scan_run)."""
    if x.dtype == torch.float32:
        return biquad_scan_run_df(A, Bv, c0, states, x, out)
    if x.is_cuda:
        return _launch_biquad_run(biquad_scan_run, A, Bv, c0, states, x, out)
    return _run_on_cpu(biquad_scan_run, A, Bv, c0, states, x, out)


biquad_scan_run.launches = 0


def biquad_scan_run_df(A, Bv, c0, states, x, out=None):
    """biquad_scan_run on float32 x [B, C] and float32 states, K3 a stage:
    float64 coefficients and registers, as n separate biquad_scan_df calls
    (a single [C, 2] state, or a [2, C, 2] (hi, lo) one). CPU tensors run
    biquad_scan_run_ref; CUDA tensors launch csrc/biquad_scan.cu."""
    if x.is_cuda:
        return _launch_biquad_run(biquad_scan_run_df, A, Bv, c0, states, x, out)
    return _run_on_cpu(biquad_scan_run_df, A, Bv, c0, states, x, out)


biquad_scan_run_df.launches = 0


def biquad_scan_run_ref(A, Bv, c0, states, x):
    """Plain PyTorch version of biquad_scan_run and biquad_scan_run_df: the
    n separate plain calls in order (biquad_scan_ref, biquad_scan_pair_ref
    or biquad_scan_df_ref), each stage on the one before's output; x
    [S, B, C] and each state [S, C, 2] or [S, 2, C, 2] a stream at a
    time."""
    if x.dim() == 3:
        runs = [biquad_scan_run_ref(A, Bv, c0, [st[s] for st in states], x[s])
                for s in range(x.shape[0])]
        return ([torch.stack([r[0][k] for r in runs]) for k in range(len(states))],
                torch.stack([r[1] for r in runs]))
    ends = []
    for s, st in enumerate(states):
        if x.dtype == torch.float32:
            st, x = biquad_scan_df_ref(A[s], Bv[s], c0[s], st, x)
        elif _is_pair(st, x):
            st, x = biquad_scan_pair_ref(A[s], Bv[s], c0[s], st, x)
        else:
            st, x = biquad_scan_ref(A[s], Bv[s], c0[s], st, x)
        ends.append(st)
    return ends, x


def _run_dtype(wrapper):
    return torch.float32 if wrapper is biquad_scan_run_df else torch.float64


def _run_on_cpu(wrapper, A, Bv, c0, states, x, out):
    """The plain version for CPU tensors (any other device but CUDA
    raises), the end states written into `out` when it is given."""
    dt = _run_dtype(wrapper)
    _check_dtypes(wrapper.__name__, (x, dt), (A, torch.float64), (Bv, torch.float64),
                  (c0, torch.float64), *[(t, dt) for t in states])
    if x.device.type != "cpu":
        raise ValueError(f"{wrapper.__name__}: no kernel for device {x.device}")
    ends, y = biquad_scan_run_ref(A, Bv, c0, states, x)
    if out is None:
        return ends, y
    for o, e in zip(out, ends):
        o.copy_(e)
    return list(out), y


def _launch_biquad_run(wrapper, A, Bv, c0, states, x, out):
    """The checks of _check_dtypes, _check_cuda and the states' layout,
    written out for the one call, then the launch."""
    from dsp_tpu_torch import kernels

    name, f64 = wrapper.__name__, torch.float64
    if x.dtype != _run_dtype(wrapper) or A.dtype != f64 or Bv.dtype != f64 or c0.dtype != f64:
        raise TypeError(f"{name}: the kernel takes float64 coefficients and "
                        f"{_run_dtype(wrapper)} x, got {A.dtype}, {Bv.dtype}, {c0.dtype}, "
                        f"{x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"{name}: x must be [B, C] or [S, B, C], got {tuple(x.shape)}")
    B, C = x.shape[-2:]
    lead = tuple(x.shape[:-2])
    n = len(states)
    if not 1 <= n <= kernels.BIQUAD_RUN_MAX_STAGES:
        raise ValueError(f"{name}: {n} stages, at most {kernels.BIQUAD_RUN_MAX_STAGES}")
    dev = x.get_device()
    for what, t, shape in (("x", x, (*lead, B, C)), ("A", A, (n, C, 2, 2)), ("Bv", Bv, (n, C, 2)),
                           ("c0", c0, (n, C))):
        if t.shape != shape or t.get_device() != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {what} {tuple(t.shape)} on {t.device}, expected a "
                             f"contiguous {shape} on {x.device}")
    shape, strides = states[0].shape, states[0].stride()
    pair = _is_pair(states[0], x)
    if shape not in ((*lead, C, 2), (*lead, 2, C, 2)) or strides[-1] != 1:
        raise ValueError(f"{name}: states {tuple(shape)} with strides {strides}, expected "
                         f"{[*lead, C, 2]} or {[*lead, 2, C, 2]} with each lane's values "
                         f"adjacent")
    if out is None:
        out = torch.empty((n, *shape), dtype=x.dtype, device=x.device).unbind(0)
    if len(out) != n:
        raise ValueError(f"{name}: {len(out)} outputs for {n} stages")
    for t in (*states, *out):
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: the kernel takes {x.dtype} states, got {t.dtype}")
        if t.shape != shape or t.stride() != strides or t.get_device() != dev:
            raise ValueError(f"{name}: every state in and out must be {tuple(shape)} with "
                             f"strides {strides} on {x.device}")
    y = torch.empty_like(x)
    kernels.launch_biquad_scan_run(A, Bv, c0, states, out, x, y, strides[-2],
                                   strides[-3] if pair else 0, strides[0] if lead else 0, pair)
    wrapper.launches += 1
    return list(out), y


def crossfeed_lanes(x, col0, col1):
    """crossfeed's four scan lanes [..., B, 4] from x's columns: [s1, s0,
    s0, s1] (lowpass of s1 and of s0, highpass of s0 and of s1)."""
    s0, s1 = x[..., col0], x[..., col1]
    return torch.stack([s1, s0, s0, s1], dim=-1)


def crossfeed_mix(x, y, col0, col1, direct, cross):
    """crossfeed's output: x with columns col0 and col1 replaced by
    s0·direct + y0·cross + y2·cross and s1·direct + y1·cross + y3·cross."""
    s0, s1 = x[..., col0], x[..., col1]
    out = x.clone()
    out[..., col0] = s0 * direct + y[..., 0] * cross + y[..., 2] * cross
    out[..., col1] = s1 * direct + y[..., 1] * cross + y[..., 3] * cross
    return out


def crossfeed_step(A, Bv, c0, state, x, col0, col1, direct, cross):
    """crossfeed's whole step (dsp_tpu/effects/crossfeed.py:40-55) in one
    launch: the four first-order lanes (A [4,2,2], Bv [4,2], c0 [4], state
    [4,2], the companion form) on x's columns col0 and col1, and the mix
    with the gains direct and cross. x [B, C]; all float64, or all float32
    (crossfeed_step_f32). Returns (state' [4,2], out [B,C]); with a stream
    axis x [S,B,C] and state [S,4,2], the pair (col0, col1) of each stream.
    CPU tensors run crossfeed_step_ref; CUDA tensors launch
    csrc/biquad_scan.cu."""
    if x.dtype == torch.float32:
        return crossfeed_step_f32(A, Bv, c0, state, x, col0, col1, direct, cross)
    _check_dtypes("crossfeed_step", *[(t, torch.float64) for t in (x, state, A, Bv, c0)])
    if x.device.type == "cpu":
        return crossfeed_step_ref(A, Bv, c0, state, x, col0, col1, direct, cross)
    return _launch_crossfeed(crossfeed_step, A, Bv, c0, state, x, col0, col1, direct, cross)


crossfeed_step.launches = 0


def crossfeed_step_f32(A, Bv, c0, state, x, col0, col1, direct, cross):
    """crossfeed_step in float32: the scan as biquad_scan_f32's, the mix
    with the gains rounded to float32, as torch's float32 scalar multiply
    takes them. CPU tensors run crossfeed_step_ref; CUDA tensors launch
    csrc/biquad_scan.cu."""
    _check_dtypes("crossfeed_step_f32", *[(t, torch.float32) for t in (x, state, A, Bv, c0)])
    if x.device.type == "cpu":
        return crossfeed_step_ref(A, Bv, c0, state, x, col0, col1, direct, cross)
    return _launch_crossfeed(crossfeed_step_f32, A, Bv, c0, state, x, col0, col1, direct, cross)


crossfeed_step_f32.launches = 0


def crossfeed_step_ref(A, Bv, c0, state, x, col0, col1, direct, cross):
    """Plain PyTorch version of crossfeed_step and crossfeed_step_f32: the
    lanes stacked, K2's plain version of x's dtype, the mix; x [S, B, C]
    and state [S, 4, 2] a stream at a time."""
    if x.dim() == 3:
        return each_stream(
            lambda st, xs: crossfeed_step_ref(A, Bv, c0, st, xs, col0, col1, direct, cross),
            state, x)
    scan = biquad_scan_f32_ref if x.dtype == torch.float32 else biquad_scan_ref
    state, y = scan(A, Bv, c0, state, crossfeed_lanes(x, col0, col1))
    return state, crossfeed_mix(x, y, col0, col1, direct, cross)


def _launch_crossfeed(wrapper, A, Bv, c0, state, x, col0, col1, direct, cross):
    from dsp_tpu_torch import kernels

    C = _check_cuda(wrapper.__name__, x, state, A, Bv, c0)[2]
    _check_shapes(wrapper.__name__, A, Bv, c0, state, 4, x.shape[:-2])
    if not (0 <= col0 < C and 0 <= col1 < C and col0 != col1):
        raise ValueError(f"{wrapper.__name__}: columns {col0}, {col1} of {C}")
    out = torch.empty_like(x)
    state_out = torch.empty_like(state)
    kernels.launch_crossfeed_step(A, Bv, c0, state, state_out, x, out, col0, col1, direct, cross)
    wrapper.launches += 1
    return state_out, out


def _check_shapes(name, A, Bv, c0, state, n, lead=()):
    """Raise unless A, Bv, c0 and state are of n lanes: [n,2,2], [n,2], [n],
    [*lead, n,2]."""
    for what, t, shape in (("A", A, (n, 2, 2)), ("Bv", Bv, (n, 2)), ("c0", c0, (n,)),
                           ("state", state, (*lead, n, 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} {tuple(t.shape)}, expected {shape}")


def _is_pair(state, x):
    """Whether a biquad state beside x is a (hi, lo) pair ([2, C, 2], or
    [S, 2, C, 2] beside x [S, B, C]) rather than a single [C, 2] or
    [S, C, 2]."""
    return state.dim() == x.dim() + 1


def _launch_biquad_scan(wrapper, A, Bv, c0, state, x, pair):
    from dsp_tpu_torch import kernels

    S, B, C = _check_cuda(wrapper.__name__, x, state, A, Bv, c0)
    state_shape = (*x.shape[:-2], *((2,) if pair else ()), C, 2)
    for name, t, shape in (("A", A, (C, 2, 2)), ("Bv", Bv, (C, 2)), ("c0", c0, (C,)),
                           ("state", state, state_shape)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{wrapper.__name__}: {name} {tuple(t.shape)}, expected {shape}")
    y = torch.empty_like(x)
    state_out = torch.empty_like(state)
    kernels.launch_biquad_scan(A, Bv, c0, state, state_out, x, y, S, pair)
    wrapper.launches += 1
    return state_out, y


def biquad_scan_ref(A, Bv, c0, state, x):
    """Plain PyTorch version of K2 (any device, float64 or float32): a
    Hillis-Steele doubling scan of the affine maps over the sample axis,
    log2(B) steps; x [S, B, C] and state [S, C, 2] a stream at a time."""
    if x.dim() == 3:
        return each_stream(lambda st, xs: biquad_scan_ref(A, Bv, c0, st, xs), state, x)
    B = x.shape[0]
    M = A.expand((B,) + tuple(A.shape))  # [B, C, 2, 2]
    v = x[..., None] * Bv  # [B, C, 2]
    d = 1
    while d < B:
        Mh = M[d:]
        M = torch.cat([M[:d], Mh @ M[:-d]])
        v = torch.cat([v[:d], (Mh @ v[:-d, ..., None])[..., 0] + v[d:]])
        d *= 2
    s = (M @ state[..., None])[..., 0] + v  # s[t] = M[t] s0 + v[t]
    m0_prev = torch.cat([state[None, :, 0], s[:-1, :, 0]])
    return s[-1], c0 * x + m0_prev


def _compose(first, second):
    """`second` after `first`, for affine maps (m00, m01, m10, m11, v0, v1)
    of tensors, as csrc/biquad_scan.cu's compose."""
    f, s = first, second
    return (s[0] * f[0] + s[1] * f[2], s[0] * f[1] + s[1] * f[3],
            s[2] * f[0] + s[3] * f[2], s[2] * f[1] + s[3] * f[3],
            s[0] * f[4] + s[1] * f[5] + s[4], s[2] * f[4] + s[3] * f[5] + s[5])


def biquad_scan_f32_ref(A, Bv, c0, state, x):
    """Plain PyTorch version of biquad_scan_f32, in the kernel's order of
    operations, so that its float32 rounding is the kernel's but for the
    card's fused multiply-adds: T threads a lane (B/16 rounded up to a warp,
    32..1024), each composing its segment of ceil(B/T) samples; an
    inclusive scan of the maps inside each warp of 32 (doubling), the warp
    totals scanned in order; each segment rerun from its start state. The
    float64 K2 keeps its doubling scan (biquad_scan_ref). x [S, B, C]
    and state [S, C, 2] a stream at a time."""
    if x.dim() == 3:
        return each_stream(lambda st, xs: biquad_scan_f32_ref(A, Bv, c0, st, xs), state, x)
    B, C = x.shape
    T = min(1024, max(32, ((B + 15) // 16 + 31) // 32 * 32))
    seg = -(-B // T)
    xs = torch.cat([x, x.new_zeros((T * seg - B, C))]).reshape(T, seg, C)
    valid = (torch.arange(T * seg, device=x.device) < B).reshape(T, seg, 1)
    a00, a01, a10, a11 = A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1]
    one, zero = x.new_ones((T, C)), x.new_zeros((T, C))
    f = (one, zero, zero, one, zero, zero)
    for t in range(seg):  # 1. each segment's map
        xt = xs[:, t]
        step = (a00 * f[0] + a01 * f[2], a00 * f[1] + a01 * f[3],
                a10 * f[0] + a11 * f[2], a10 * f[1] + a11 * f[3],
                a00 * f[4] + a01 * f[5] + Bv[:, 0] * xt, a10 * f[4] + a11 * f[5] + Bv[:, 1] * xt)
        f = tuple(torch.where(valid[:, t], n, o) for n, o in zip(step, f))
    # 2. inclusive scan inside each warp, then its totals in order
    f = tuple(m.reshape(T // 32, 32, C) for m in f)
    for d in (1, 2, 4, 8, 16):
        g = _compose(tuple(m[:, :-d] for m in f), tuple(m[:, d:] for m in f))
        f = tuple(torch.cat([m[:, :d], n], dim=1) for m, n in zip(f, g))
    ident = (one[:1], zero[:1], zero[:1], one[:1], zero[:1], zero[:1])
    excl = tuple(torch.cat([i[:, None].expand(T // 32, 1, C), m[:, :-1]], dim=1)
                 for i, m in zip(ident, f))
    run, starts = ident, []
    for w in range(T // 32):
        starts.append(run)
        run = _compose(run, tuple(m[w:w + 1, -1] for m in f))
    starts = tuple(torch.stack(m).expand(T // 32, 32, C) for m in zip(*starts))
    pre = tuple(m.reshape(T, C) for m in _compose(starts, excl))
    # 3. each segment rerun from its start state
    u0 = pre[0] * state[:, 0] + pre[1] * state[:, 1] + pre[4]
    u1 = pre[2] * state[:, 0] + pre[3] * state[:, 1] + pre[5]
    ys = []
    for t in range(seg):
        xt = xs[:, t]
        ys.append(c0 * xt + u0)
        n0 = a00 * u0 + a01 * u1 + Bv[:, 0] * xt
        n1 = a10 * u0 + a11 * u1 + Bv[:, 1] * xt
        u0 = torch.where(valid[:, t], n0, u0)
        u1 = torch.where(valid[:, t], n1, u1)
    y = torch.stack(ys, dim=1).reshape(T * seg, C)[:B]
    return torch.stack([u0[-1], u1[-1]], dim=-1), y


def biquad_scan_df_ref(A, Bv, c0, state, x):
    """Plain PyTorch version of K3: biquad_scan_ref in float64 on the
    upcast x and state (hi + lo), then y rounded to float32 and the state
    split, or, a single state, rounded; x [S, B, C] and the state
    [S, 2, C, 2] or [S, C, 2] a stream at a time."""
    if x.dim() == 3:
        return each_stream(lambda st, xs: biquad_scan_df_ref(A, Bv, c0, st, xs), state, x)
    s = state.double() if state.dim() == 2 else state[0].double() + state[1].double()
    s_end, y = biquad_scan_ref(A, Bv, c0, s, x.double())
    return (s_end.float() if state.dim() == 2 else torch.stack(split_f64(s_end))), y.float()


def biquad_scan_auto(c, state, x):
    """dsp_tpu's biquad_scan_auto (iir.py:129): the biquads of host
    coefficients c [5, C] (numpy) on state [C, 2] and x [B, C]. Under
    float32 the coupled form on K3, the state handed in and out as one
    float32 array (dsp_tpu's hi + lo, rounded); under float64 the same
    coupled form on K2."""
    c = np.asarray(c, dtype=np.float64)
    A, Bv = _coupled_form_ss(c)
    coef = (torch.as_tensor(a, dtype=torch.float64, device=x.device) for a in (A, Bv, c[0]))
    return biquad_scan_coupled(*coef, state, x)


def biquad_scan_coupled(A, Bv, c0, state, x):
    """The biquads of float64 coupled-form coefficients (A [C,2,2],
    Bv [C,2], c0 [C]) on a state [C, 2] and x [B, C] of x's dtype: K2 on
    float64, K3 with a single float32 state on float32."""
    if x.dtype == torch.float32:
        return biquad_scan_df(A, Bv, c0, state, x)
    return biquad_scan(A, Bv, c0, state, x)


def _check_cuda(name, x, *others):
    """Raise unless x is [B, C] or [S, B, C] on a CUDA device and every
    tensor is contiguous on x's device; returns (S, B, C), S = 1 for
    [B, C]."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dim() not in (2, 3):
        raise ValueError(f"{name}: x must be [B, C] or [S, B, C], got {tuple(x.shape)}")
    for t in (x,) + others:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return (x.shape[0] if x.dim() == 3 else 1, *x.shape[-2:])
