"""K2 in the launches the chain makes with it (dsp_tpu_torch.ops.iir):
crossfeed's whole step (crossfeed_step, crossfeed_step_f32), matrix4's
band-limit pair (biquad_scan_series) and the per-sample biquad path's
(hi, lo) state (biquad_scan_pair).

On the CPU each wrapper runs its plain version: the torch composition the
kernel replaces. These tests hold crossfeed's against dsp_tpu's
CrossfeedEffect.step, in float64 and against dsp_tpu float32, and hold the
other two, bit for bit, to the calls they stand for. Seeded numpy inputs.
"""

import numpy as np
import pytest
import torch

import dsp_tpu_torch.ops.iir as tiir
from torch_parity import FLAGSHIP, FS, port_chain

# crossfeed against dsp_tpu: the same recurrences, dsp_tpu's associative
# scan and the port's doubling scan (float64) or segment order (float32)
# group the sums differently. Relative to max(1, peak |y|): float64 as
# tests/test_torch_iir.py holds K2 (1e-13; measured 1.0e-16 to 2.1e-16
# over the layouts below); float32 about one float32 ulp of the output
# scale (measured 5.5e-8 to 1.1e-7), pinned at 1e-6.
REL_F64 = 1e-13
REL_F32 = 1e-6

# (channels, selector, the columns it selects)
LAYOUTS = [(2, "", (0, 1)), (4, ":3,1 ", (1, 3)), (6, ":2,5 ", (2, 5)), (6, ":4,0 ", (0, 4))]
LAYOUT_IDS = ["2ch", "4ch cols 1,3", "6ch cols 2,5", "6ch cols 0,4"]


def _both_crossfeeds(channels, sel, dtype):
    import jax.numpy as jnp

    from dsp_tpu.chain import build_chain_from_string as jbuild
    from dsp_tpu.core.types import StreamInfo as JInfo
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    spec = f"{sel}crossfeed 700 4.5"
    je = jbuild(spec, JInfo(FS, channels)).effects[0]
    te = build_chain_from_string(spec, StreamInfo(FS, channels)).effects[0]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return je, te, jdt


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("channels,sel,cols", LAYOUTS, ids=LAYOUT_IDS)
def test_crossfeed_step_matches_dsp_tpu(channels, sel, cols, dtype):
    """crossfeed's fused step (its plain version on the CPU) against
    dsp_tpu's CrossfeedEffect.step over blocks of 1000, 1000, 7 and 1000
    samples, each package carrying its own state; the pass-through columns
    equal."""
    import jax.numpy as jnp

    je, te, jdt = _both_crossfeeds(channels, sel, dtype)
    assert (te.c0, te.c1) == cols == (je.c0, je.c1)
    rng = np.random.default_rng(channels + len(sel))
    npdt = np.float64 if dtype == torch.float64 else np.float32
    js = jnp.asarray(je.state0(), dtype=jdt)
    ts = torch.as_tensor(te.state0(), dtype=dtype)
    rel = REL_F64 if dtype == torch.float64 else REL_F32
    for B in (1000, 1000, 7, 1000):
        x = (rng.standard_normal((B, channels)) * 0.3).astype(npdt)
        js, jy = je.step(js, jnp.asarray(x))
        ts, ty = te.step(ts, torch.as_tensor(x))
        assert ty.dtype == dtype and ts.dtype == dtype
        jy, ty = np.asarray(jy, np.float64), ty.double().numpy()
        peak = max(1.0, float(np.abs(jy).max()))
        assert np.abs(ty - jy).max() <= rel * peak
        assert np.abs(ts.double().numpy() - np.asarray(js, np.float64)).max() <= rel * peak
        rest = [c for c in range(channels) if c not in cols]
        np.testing.assert_array_equal(ty[:, rest], x[:, rest].astype(np.float64))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("channels,sel,cols", LAYOUTS, ids=LAYOUT_IDS)
def test_crossfeed_step_is_the_composition(channels, sel, cols, dtype):
    """crossfeed_step on the CPU is, bit for bit, the composition it
    replaces on the card: the lanes stacked, K2 and the torch mix."""
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    e = build_chain_from_string(f"{sel}crossfeed 700 4.5", StreamInfo(FS, channels)).effects[0]
    sfx = "32" if dtype == torch.float32 else ""
    A, Bv, c0 = (torch.as_tensor(getattr(e, f"_ss{sfx}_{k}")) for k in ("A", "Bv", "c0"))
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((2048, channels)) * 0.3, dtype=dtype)
    st = torch.as_tensor(rng.standard_normal((4, 2)) * 1e-2, dtype=dtype)
    s_k, y_k = tiir.crossfeed_step(A, Bv, c0, st, x, *cols, e.direct_gain, e.cross_gain)
    s_c, y = tiir.biquad_scan(A, Bv, c0, st, tiir.crossfeed_lanes(x, *cols))
    y_c = tiir.crossfeed_mix(x, y, *cols, e.direct_gain, e.cross_gain)
    assert torch.equal(s_k, s_c) and torch.equal(y_k, y_c)


def _matrix4():
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    return build_chain_from_string("matrix4 -6", StreamInfo(FS, 2)).effects[0]


@pytest.mark.parametrize("B", [1, 7, 1000, 2048])
def test_band_limit_pair_is_two_scans(B):
    """biquad_scan_series with matrix4's band-limit coefficients equals,
    bit for bit, the two biquad_scan_ref calls and the states'
    concatenation that it replaces."""
    e = _matrix4()
    t = {k: torch.as_tensor(getattr(e, k)) for k in (
        "A_bl", "B_bl", "c0_bl", "A_hp", "B_hp", "c0_hp", "A_lp", "B_lp", "c0_lp")}
    rng = np.random.default_rng(B)
    x = torch.as_tensor(rng.standard_normal((B, 2)) * 0.3)
    st = torch.as_tensor(rng.standard_normal((4, 2)) * 1e-2)
    s_k, y_k = tiir.biquad_scan_series(t["A_bl"], t["B_bl"], t["c0_bl"], st, x)
    s1, y1 = tiir.biquad_scan_ref(t["A_hp"], t["B_hp"], t["c0_hp"], st[:2], x)
    s2, y2 = tiir.biquad_scan_ref(t["A_lp"], t["B_lp"], t["c0_lp"], st[2:], y1)
    assert torch.equal(s_k, torch.cat([s1, s2])) and torch.equal(y_k, y2)


def _unfused_biquad_step(self, state, x):
    """BiquadEffect.step's float64 per-sample path before the (hi, lo)
    state moved into the kernel: K2 on hi + lo, the end state stacked over
    zeros."""
    A, Bv, c0 = (self.device_array(k, x) for k in ("_ss_A", "_ss_Bv", "_ss_c0"))
    s_end, y = tiir.biquad_scan(A, Bv, c0, state[0] + state[1], x)
    return torch.stack([s_end, torch.zeros_like(s_end)]), y


def _unfused_crossfeed_step(self, state, x):
    """CrossfeedEffect.step as fifteen torch ops around K2."""
    ss = "_ss32" if x.dtype == torch.float32 else "_ss"
    A, Bv, c0c = (self.device_array(ss + k, x) for k in ("_A", "_Bv", "_c0"))
    s0, s1 = x[:, self.c0], x[:, self.c1]
    state, y = tiir.biquad_scan(A, Bv, c0c, state, torch.stack([s1, s0, s0, s1], dim=1))
    out = x.clone()
    out[:, self.c0] = s0 * self.direct_gain + y[:, 0] * self.cross_gain + y[:, 2] * self.cross_gain
    out[:, self.c1] = s1 * self.direct_gain + y[:, 1] * self.cross_gain + y[:, 3] * self.cross_gain
    return state, out


@pytest.mark.parametrize("spec,block", [(FLAGSHIP, 1000), ("highpass 30 0.7071", 1000),
                                        (FLAGSHIP, 2048)], ids=["flagship -b 1000",
                                                                "highpass -b 1000",
                                                                "flagship -b 2048"])
def test_chain_equals_the_unfused_formulas(spec, block, monkeypatch):
    """The chain through CompiledChain on the CPU (the f64 per-sample
    biquads at -b 1000 as one biquad_scan_run, crossfeed on crossfeed_step)
    equals, bit for bit, the same chain with each biquad stepped alone and
    the step formulas of the torch ops around a generic K2 launch, states
    included."""
    from dsp_tpu_torch.chain import CompiledChain
    from dsp_tpu_torch.effects.biquad import BiquadEffect
    from dsp_tpu_torch.effects.crossfeed import CrossfeedEffect

    rng = np.random.default_rng(block)
    x = rng.standard_normal((3 * block + 123, 2)) * 0.2
    new = port_chain(spec, block)
    y_new = new.process_array(x)
    monkeypatch.setattr(BiquadEffect, "step", lambda self, s, xb: (
        _unfused_biquad_step(self, s, xb) if xb.shape[0] % tiir.BLOCKED_L or xb.shape[0] < 256
        else tiir.lti_blocked(self._plan(), s, xb)))
    monkeypatch.setattr(CrossfeedEffect, "step", _unfused_crossfeed_step)
    monkeypatch.setattr(CompiledChain, "_schedule", lambda self, effects: [(e, 0) for e in effects])
    old = port_chain(spec, block)
    y_old = old.process_array(x)
    np.testing.assert_array_equal(y_new, y_old)
    assert _leaves(new.states) and _leaves(new.states) == _leaves(old.states)


def _leaves(tree):
    """A state tree's tensors as (dtype, bytes), in order."""
    if isinstance(tree, torch.Tensor):
        return [(tree.dtype, tree.numpy().tobytes())]
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _leaves(t)]
    return []


def test_per_sample_state_is_hi_plus_lo():
    """biquad_scan_pair reads hi + lo and returns (s, 0)."""
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    e = build_chain_from_string("highpass 30 0.7071", StreamInfo(FS, 2)).effects[0]
    A, Bv, c0 = (torch.as_tensor(getattr(e, k)) for k in ("_ss_A", "_ss_Bv", "_ss_c0"))
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((1000, 2)) * 0.3)
    st = torch.as_tensor(rng.standard_normal((2, 2, 2)) * 1e-2)
    st[1] *= 1e-9
    s_k, y_k = tiir.biquad_scan_pair(A, Bv, c0, st, x)
    s_r, y_r = tiir.biquad_scan_ref(A, Bv, c0, st[0] + st[1], x)
    assert torch.equal(y_k, y_r) and torch.equal(s_k[0], s_r)
    assert torch.equal(s_k[1], torch.zeros_like(s_r))


def _meta(*shapes, dtype=torch.float64):
    return [torch.empty(s, dtype=dtype, device="meta") for s in shapes]


@pytest.mark.parametrize("wrapper", ["crossfeed_step", "crossfeed_step_f32",
                                     "biquad_scan_series", "biquad_scan_pair"])
def test_fused_wrappers_take_no_plain_path_off_the_cpu(wrapper):
    """Only a CPU tensor reaches a plain version: any other device goes to
    the CUDA kernel or raises (here: meta tensors, which have none), and
    nothing is counted."""
    dtype = torch.float32 if wrapper.endswith("f32") else torch.float64
    if wrapper.startswith("crossfeed"):
        args = _meta((4, 2, 2), (4, 2), (4,), (4, 2), (256, 2), dtype=dtype) + [0, 1, 0.6, 0.4]
    elif wrapper == "biquad_scan_series":
        args = _meta((4, 2, 2), (4, 2), (4,), (4, 2), (256, 2))
    else:
        args = _meta((2, 2, 2), (2, 2), (2,), (2, 2, 2), (256, 2))
    fn = getattr(tiir, wrapper)
    before = fn.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fn(*args)
    assert fn.launches == before
