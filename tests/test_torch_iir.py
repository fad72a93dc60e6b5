"""K1 and K2 of dsp_tpu_torch.ops.iir against dsp_tpu.ops.iir.

On the CPU the port's wrappers run the plain PyTorch versions
(lti_blocked_ref, biquad_scan_ref); dsp_tpu runs its jnp functions on the
CPU in float64. Same seeded numpy inputs, same host tables.
"""

import numpy as np
import pytest
import torch

import dsp_tpu.ops.iir as jiir
import dsp_tpu_torch.ops.iir as tiir
from torch_parity import FLAGSHIP, FS

# Both sides are float64 recurrences that differ only in summation order.
# The error scales with the signal, and random plans reach gains of ~35, so
# the bound is relative to max(1, peak |y|): measured -278 dB at worst on
# these cases; -260 dB (1e-13) keeps an 18 dB margin.
REL_LIMIT = 1e-13


def _close(got, want, peak):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max(initial=0.0))
    assert err <= REL_LIMIT * max(1.0, peak), f"max |diff| {err:.3e} for peak {peak:.3g}"


def _flagship_stages():
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.biquad import BiquadEffect

    chain = build_chain_from_string(FLAGSHIP, StreamInfo(FS, 2))
    return [e.c for e in chain.effects if type(e) is BiquadEffect]


def _random_stage(rng, channels):
    """A stable biquad [5, C]: complex poles at radius < 0.999, any zeros."""
    r = rng.uniform(0.3, 0.999, channels)
    th = rng.uniform(1e-3, 0.99 * np.pi, channels)
    b = rng.standard_normal((3, channels))
    return np.stack([b[0], b[1], b[2], -2 * r * np.cos(th), r * r])


def _stages(kind):
    if kind == "flagship":
        return _flagship_stages()
    rng = np.random.default_rng(int(kind[-1]))
    return [_random_stage(rng, 2) for _ in range(int(kind[-1]))]


PLANS = ["flagship", "random1", "random2", "random3", "random4"]


@pytest.mark.parametrize("B", [256, 2048])
@pytest.mark.parametrize("kind", PLANS)
def test_lti_blocked_ref_matches_jax(kind, B):
    import jax
    import jax.numpy as jnp

    stages = _stages(kind)
    jplan = jiir.CascadeBlockedPlan(stages)
    tplan = tiir.CascadeBlockedPlan(stages)
    rng = np.random.default_rng(B)
    x = rng.standard_normal((B, 2)) * 0.3
    state = rng.standard_normal((2, 2, tplan.n)) * 0.1
    state[1] *= 1e-9  # a nonzero lo part: the port folds hi + lo as dsp_tpu does
    # jit: one compile of the whole function beats eager op-by-op dispatch
    run = jax.jit(lambda st, xx: jiir.lti_blocked(jplan, st, xx))
    s_j, y_j = run(jnp.asarray(state), jnp.asarray(x))
    s_t, y_t = tiir.lti_blocked(tplan, torch.as_tensor(state), torch.as_tensor(x))
    peak = float(np.abs(np.asarray(y_j)).max())
    _close(y_t, y_j, peak)
    _close(s_t, s_j, peak)
    assert not s_t[1].any(), "the port's outgoing lo state is zero"


@pytest.mark.parametrize("kind", PLANS)
def test_plan_tables_match_jax(kind):
    """Both packages build the same host tables from the same coefficients."""
    stages = _stages(kind)
    jplan = jiir.CascadeBlockedPlan(stages)
    tplan = tiir.CascadeBlockedPlan(stages)
    for name in ("W", "V", "P", "AL", "c0"):
        np.testing.assert_array_equal(getattr(tplan, name), getattr(jplan, name), err_msg=name)
    L = tplan.L
    for i in range(1, L):  # W is the causal Toeplitz of h: W[c, i, j] = h[c, i-1-j]
        np.testing.assert_array_equal(tplan.W[:, i, :i], tplan.h[:, i - 1 :: -1][:, :i])


def _scan_lanes(form):
    rng = np.random.default_rng(3)
    c = np.concatenate([_random_stage(rng, 1) for _ in range(4)], axis=1)  # [5, 4]
    if form == "coupled":
        A, Bv = tiir._coupled_form_ss(c)
        return A, Bv, c[0]
    return tiir.biquad_coeffs_to_ss(c)


@pytest.mark.parametrize("B", [1, 7, 128, 2048])
@pytest.mark.parametrize("form", ["coupled", "companion"])
def test_biquad_scan_ref_matches_jax(form, B):
    import jax
    import jax.numpy as jnp

    A, Bv, c0 = _scan_lanes(form)
    rng = np.random.default_rng(B)
    x = rng.standard_normal((B, 4)) * 0.3
    state = rng.standard_normal((4, 2)) * 0.1
    s_j, y_j = jax.jit(jiir.biquad_scan)(*(jnp.asarray(a) for a in (A, Bv, c0, state, x)))
    s_t, y_t = tiir.biquad_scan(*(torch.as_tensor(np.ascontiguousarray(a)) for a in (A, Bv, c0, state, x)))
    peak = float(np.abs(np.asarray(y_j)).max())
    _close(y_t, y_j, peak)
    _close(s_t, s_j, peak)


def test_biquad_scan_ref_matches_serial_recurrence():
    """The doubling scan against the per-sample TDF2 loop it replaces."""
    A, Bv, c0 = _scan_lanes("companion")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((300, 4)) * 0.3
    s = rng.standard_normal((4, 2)) * 0.1
    s_t, y_t = tiir.biquad_scan_ref(*(torch.as_tensor(np.ascontiguousarray(a)) for a in (A, Bv, c0, s, x)))
    y = np.empty_like(x)
    for t in range(len(x)):
        y[t] = c0 * x[t] + s[:, 0]
        s = np.einsum("cij,cj->ci", A, s) + Bv * x[t][:, None]
    peak = float(np.abs(y).max())
    _close(y_t, y, peak)
    _close(s_t, s, peak)


@pytest.mark.parametrize("wrapper", ["lti_blocked", "biquad_scan"])
def test_wrappers_take_no_plain_path_off_the_cpu(wrapper):
    """Only a CPU tensor reaches the plain version: any other device goes
    to the CUDA kernel or raises (here: a meta tensor, which has none)."""
    x = torch.empty((256, 2), dtype=torch.float64, device="meta")
    if wrapper == "lti_blocked":
        plan = tiir.CascadeBlockedPlan(_flagship_stages())
        state = torch.empty((2, 2, plan.n), dtype=torch.float64, device="meta")
        call = lambda: tiir.lti_blocked(plan, state, x)  # noqa: E731
    else:
        A, Bv, c0 = (torch.empty(s, dtype=torch.float64, device="meta") for s in ((2, 2, 2), (2, 2), (2,)))
        state = torch.empty((2, 2), dtype=torch.float64, device="meta")
        call = lambda: tiir.biquad_scan(A, Bv, c0, state, x)  # noqa: E731
    before = getattr(tiir, wrapper).launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call()
    assert getattr(tiir, wrapper).launches == before


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    """A failed nvcc run raises KernelBuildError and leaves no library."""
    from dsp_tpu_torch import kernels

    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels, "find_nvcc", lambda: "false")  # a compiler that fails
    lib = kernels._Library()
    with pytest.raises(kernels.KernelBuildError, match="nvcc failed"):
        lib.get()
    assert lib.lib is None
    assert not list(tmp_path.glob(f"*/{kernels.LIB_NAME}"))


def test_build_dir_keyed_by_sources(tmp_path, monkeypatch):
    """An edited source builds into a new directory; the same sources reuse one."""
    import shutil

    from dsp_tpu_torch import kernels

    assert {"lti_blocked.cu", "biquad_scan.cu"} <= {p.name for p in kernels.sources()}
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    before = kernels.build_dir()
    assert kernels.build_dir() == before and before.parent == kernels.BUILD_ROOT
    with open(csrc / "biquad_scan.cu", "a") as f:
        f.write("\n")
    assert kernels.build_dir() != before
