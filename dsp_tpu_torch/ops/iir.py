"""IIR recurrences: host plan algebra, the K1/K2 kernel wrappers and their
plain PyTorch versions.

A TDF2 biquad with normalized coefficients (c0..c4) is the 2-state linear
recurrence (biquad.c:296-315, biquad.h:76-92)

    s[n] = A s[n-1] + B x[n],   y[n] = c0 x[n] + s[n-1][0]

    A = [[-c3, 1], [-c4, 0]],   B = [c1 - c3 c0,  c2 - c4 c0]

Two kernels run these recurrences on the device:

* K1, ``lti_blocked``: an n-state LTI system (a fused cascade of biquads, or
  one biquad) over B = Nc·L samples, in chunks of L = 128, from a
  ``CascadeBlockedPlan``'s host-precomputed tables.
* K2, ``biquad_scan``: per-lane biquads over any B >= 1, with any 2x2 A.

Each wrapper dispatches on the tensor's device only: a CPU tensor runs the
plain version (``lti_blocked_ref``, ``biquad_scan_ref``), a CUDA tensor
launches the CUDA kernel (``dsp_tpu_torch/csrc/``) or raises. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.

The host algebra (``_coupled_form_ss``, ``ss_*``, the plans) is numpy
float64, as in dsp_tpu/ops/iir.py, so both packages build the same tables
from the same coefficients. States keep dsp_tpu's [2, C, n] (hi, lo) layout
with lo = 0, so a state passes between the packages unchanged.
"""

import numpy as np
import torch

# chunk length of the blocked kernel; block sizes must be multiples of this
# (and >= 2*BLOCKED_L) to take the blocked path (see BiquadEffect.step and
# chain.CompiledChain._fuse)
BLOCKED_L = 128


def biquad_coeffs_to_ss(c):
    """c: array [5, C] (c0..c4, already normalized by a0) -> companion-form
    (A [C,2,2], Bv [C,2], c0 [C]), numpy float64."""
    c = np.asarray(c, dtype=np.float64)
    c0, c1, c2, c3, c4 = c
    A = np.zeros((c.shape[1], 2, 2))
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
    ``AL`` = A^L [C, n, n] and ``c0`` = D [C].
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
        pows = np.zeros((L + 1, C, n, n))
        pows[0] = np.eye(n)[None]
        for k in range(1, L + 1):
            pows[k] = np.einsum("cij,cjk->cik", A, pows[k - 1])
        # composite impulse response h[k] = C A^(k-1) B (k >= 1); h[0] = D
        h = np.einsum("ci,kcij,cj->kc", Crow, pows[: L - 1], B)  # h[1..L-1]
        self.h = np.zeros((C, L))
        self.h[:, : L - 1] = h.T
        W = np.zeros((C, L, L))
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
        self.B_in = B
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


class BiquadBlockedPlan(CascadeBlockedPlan):
    """A one-stage cascade: the blocked plan of a single biquad."""

    def __init__(self, c, L=BLOCKED_L):
        super().__init__([c], L)


# --- K1: blocked LTI filter -------------------------------------------------


def lti_blocked(plan, state, x):
    """Run a block through a CascadeBlockedPlan (K1).

    state: [2, C, n] (hi, lo); x: [B, C] with B a multiple of plan.L.
    Returns (state' [2, C, n] with lo = 0, y [B, C]). CPU tensors run
    lti_blocked_ref; CUDA tensors launch csrc/lti_blocked.cu."""
    if x.device.type == "cpu":
        return lti_blocked_ref(plan, state, x)
    from dsp_tpu_torch import kernels

    B, C = _check_cuda_f64("lti_blocked", x, state)
    L, n = plan.L, plan.n
    if C != plan.C or B % L:
        raise ValueError(f"lti_blocked: x {tuple(x.shape)} does not fit a plan of C={plan.C}, L={L}")
    if tuple(state.shape) != (2, C, n):
        raise ValueError(f"lti_blocked: state {tuple(state.shape)}, expected {(2, C, n)}")
    h, V, P, AL, c0 = (plan.table(k, x.device) for k in ("h", "V", "P", "AL", "c0"))
    Nc = B // L
    y = torch.empty_like(x)
    state_out = torch.empty_like(state)
    v = torch.empty((Nc, C, n), dtype=x.dtype, device=x.device)
    s_start = torch.empty_like(v)
    kernels.launch_lti_blocked(x, y, state, state_out, h, V, P, AL, c0, v, s_start, L)
    lti_blocked.launches += 1
    return state_out, y


lti_blocked.launches = 0


def lti_blocked_ref(plan, state, x):
    """Plain PyTorch version of K1 (any device): einsums for the chunk
    products, a loop over the Nc chunks for the carry."""
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


# --- K2: per-lane biquad scan -----------------------------------------------


def biquad_scan(A, Bv, c0, state, x):
    """Run one block of per-lane biquads (K2).

    A [C,2,2], Bv [C,2], c0 [C]; state [C,2] (TDF2 memories); x [B,C].
    Returns (state' [C,2], y [B,C]). CPU tensors run biquad_scan_ref; CUDA
    tensors launch csrc/biquad_scan.cu."""
    if x.device.type == "cpu":
        return biquad_scan_ref(A, Bv, c0, state, x)
    from dsp_tpu_torch import kernels

    B, C = _check_cuda_f64("biquad_scan", x, state, A, Bv, c0)
    for name, t, shape in (("A", A, (C, 2, 2)), ("Bv", Bv, (C, 2)), ("c0", c0, (C,)),
                           ("state", state, (C, 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"biquad_scan: {name} {tuple(t.shape)}, expected {shape}")
    y = torch.empty_like(x)
    state_out = torch.empty_like(state)
    kernels.launch_biquad_scan(A, Bv, c0, state, state_out, x, y)
    biquad_scan.launches += 1
    return state_out, y


biquad_scan.launches = 0


def biquad_scan_ref(A, Bv, c0, state, x):
    """Plain PyTorch version of K2 (any device): a Hillis-Steele doubling
    scan of the affine maps over the sample axis, log2(B) steps."""
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


def _check_cuda_f64(name, x, *others):
    """Raise unless every tensor is a contiguous float64 on x's CUDA device;
    returns x's (B, C)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [B, C], got {tuple(x.shape)}")
    for t in (x,) + others:
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: the kernel takes float64, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return x.shape
