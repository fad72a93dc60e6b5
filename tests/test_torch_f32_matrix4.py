"""dsp_tpu_torch's float32 matrix4 and matrix4_mb (K9-K13 in float32)
against dsp_tpu, on the CPU.

dsp_tpu runs the whole control path of both upmixes in two-float32 under
float32 (dfx.DF; K19's scalar functions) and the audio path in float32.
The port reads float32, computes in float64 and stores float32, each state
leaf that dsp_tpu keeps as a (hi, lo) pair written back split
(dsp_tpu_torch/ops/m4_engine.py). So parity is against dsp_tpu float64, held
as dsp_tpu's own tests hold its float32 path (tests/test_f32_accuracy.py's
TestMatrix4ControlSplit and TestMatrix4MbControlSplit, on their signal):
the float32 audio path under control pinned from dsp_tpu float64's run
within -120 dBFS of dsp_tpu float64, and the full float32 run (control
included: the engines' decisions flip under rounding, PARITY.md:192-214)
within -100 dBFS (matrix4) and -95 dBFS (matrix4_mb).
Here: the parts, each float32 plain version against the float64 plain
version fed the same values (hi + lo); block-size independence; the
float32 state trees against dsp_tpu's (its float32 chains built, which
compiles nothing: their load_state checks the tree); and the float64
registers against dsp_tpu's dfx (K19). The runs against dsp_tpu (the
control split, a checkpoint crossing through dsp_tpu's float32 step) are in
test_torch_f32_matrix4_split.py, which renders dsp_tpu float64 once for
all of them.
"""

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from test_torch_matrix4 import transient_signal
from torch_parity import FS, worst_dbfs

B = 2048


def split_signal(n):
    """tests/test_f32_accuracy.py's control-split signal: a 440 Hz tone on
    both channels (0.4 rad apart), a 97 Hz tone on the left and a
    Hann-windowed noise burst on the right."""
    rng = np.random.default_rng(1)
    t = np.arange(n) / FS
    x = np.zeros((n, 2))
    x[:, 0] = 0.35 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 97 * t)
    x[:, 1] = (0.35 * np.sin(2 * np.pi * 440 * t + 0.4)
               + 0.1 * rng.standard_normal(n) * np.hanning(n))
    return x


def _port_effect(spec, dtype, block=B):
    """(the port's effect of `spec`, its state) in a CompiledChain of dtype
    on the CPU (every state leaf cast as the chain casts it)."""
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    cc = CompiledChain(build_chain_from_string(spec, StreamInfo(FS, 2)), block, dtype=dtype,
                       device="cpu")
    i = next(i for i, e in enumerate(cc._runtime_effects) if type(e).__name__.startswith("Matrix4"))
    return cc._runtime_effects[i], cc.states[i]


SPECS = ("matrix4 -6", "matrix4_mb -6")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _pair(a):
    return a[0].double() + a[1].double()


def _warm(spec, fs=FS, block=B, blocks=4, seed=3):
    """The port's float32 effect and its state after `blocks` blocks of
    transients at `block`, and the next block."""
    e, st = _port_effect(spec, torch.float32, block)
    x = torch.as_tensor(transient_signal((blocks + 1) * block / fs + 0.01, fs, seed=seed)
                        [:(blocks + 1) * block], dtype=torch.float32)
    for b in range(blocks):
        st, _ = e.step(st, x[b * block:(b + 1) * block])
    return e, st, x[blocks * block:]


def _assert_state(new, new_lo, want):
    """A float32 event state (ev, ev_lo) against the float64 one: the
    decisions equal, each float leaf's hi + lo within 1e-12 relative and hi
    its float32 rounding."""
    from dsp_tpu_torch.ops import m4_engine as m4

    for k, kind in m4.EV_LEAVES:
        if kind != "f":
            assert torch.equal(new[k], want[k]), k
        else:
            assert _rel(new[k].double() + new_lo[k].double(), want[k]) <= 1e-12, k
            assert torch.equal(new[k], want[k].float()), k


def test_m4_f32_parts_are_the_f64_parts():
    """matrix4: m4_env_f32, m4_event_f32 and m4_audio_f32 against m4_env,
    m4_event and m4_audio fed hi + lo in float64, mid-stream: the envelopes
    and the state within 1e-12 relative, the decisions equal, the
    coefficient sets, window and display the float64 ones with the per-tick
    values rounded to float32, the audio the float64 audio rounded once."""
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    e, st, xb = _warm("matrix4 -6")
    _, (hi, lo) = iir.lti_blocked_df(e._bp_plan(B), st["bpc"], xb)
    env = m4.m4_env_f32(hi, lo, st["env_m"], st["env_m_lo"], e.g_env)
    env64 = m4.m4_env(hi.double() + lo.double(), _pair((st["env_m"], st["env_m_lo"])), e.g_env)
    assert env[2].dtype == torch.float64 and _rel(env[2], env64[1]) <= 1e-12
    assert _rel(_pair(env[:2]), env64[0]) <= 1e-12
    lanes = {k: v[None] for k, v in st["ev"].items()}
    lanes_lo = {k: v[None] for k, v in st["ev_lo"].items()}
    bg = (st["bg_cs"][None], st["bg_cs_lo"][None])
    out = m4.m4_event_f32(e.ctl, lanes, lanes_lo, *bg, env[2][None], st["interp_y"][None], 0,
                          False)
    want = m4.m4_event_ref(e.ctl, m4.join_pairs(lanes, lanes_lo), _pair(bg), env[2][None],
                           st["interp_y"][None].double(), 0, False, torch.float32)
    _assert_state(out[0], out[1], want[0])
    assert _rel(_pair(out[2:4]), want[1]) <= 1e-12
    for got, w in zip(out[4:], want[2:]):
        assert got.dtype == torch.float32 and torch.equal(got, w)
    assert int(want[0]["diff_count"]) + int(want[0]["ord_count"]) > 0, "no event in the input"
    ics = out[4][0]
    ins = (xb, st["buf"], st["interp_c"], ics, st["shelf_m"], st["lp_m"], st["pf_m"])
    got = m4.m4_audio_f32(e.audio, *ins)
    want = m4.m4_audio(e.audio, *(t.double() for t in ins))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w.float())


def test_m4mb_f32_parts_are_the_f64_parts():
    """matrix4_mb (butterworth with freq_mask: the mix as well): m4mb_env_f32,
    m4mb_event_f32 and m4mb_audio_f32 against the float64 forms fed hi + lo,
    mid-stream: as the matrix4 test, with the thresholds' pair."""
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    e, st, xb = _warm("matrix4_mb filter_type=butterworth,freq_mask=0.5 -6", blocks=3)
    _, s_pre = e._cascade("fsh", st["fshape_m"].reshape(2, 2, 2), xb)
    _, (hi, lo) = iir.lti_blocked_df(e._bank_plan(B), st["bank"]["fused"], s_pre.repeat(1, 13))
    hi, lo = hi.view(B, 13, 2), lo.view(B, 13, 2)
    w = torch.as_tensor(e.fmw)
    env = m4.m4mb_env_f32(hi, lo, st["env_m"], st["env_m_lo"], e.g_env, w)
    env64 = m4.m4mb_env(hi.double() + lo.double(), _pair((st["env_m"], st["env_m_lo"])),
                        e.g_env, w)
    assert _rel(env[2], env64[1]) <= 1e-12 and _rel(_pair(env[:2]), env64[0]) <= 1e-12
    evt = (st["ev_thresh"], st["ev_thresh_lo"])
    out = m4.m4mb_event_f32(e.ctl, st["ev"], st["ev_lo"], *evt, env[2], st["interp_y"], 0, False)
    want = m4.m4mb_event_ref(e.ctl, m4.join_pairs(st["ev"], st["ev_lo"]), _pair(evt), env[2],
                             st["interp_y"].double(), 0, False, torch.float32)
    _assert_state(out[0], out[1], want[0])
    assert _rel(_pair(out[2:4]), want[1]) <= 1e-12
    for got, w64 in zip(out[4:], want[2:]):
        assert got.dtype == torch.float32 and torch.equal(got, w64)
    assert int(want[0]["diff_count"].sum()) + int(want[0]["ord_count"].sum()) > 0
    ins = (hi, st["fb_buf"], st["interp_c"], out[4], st["pf_m"])
    got = m4.m4mb_audio_f32(e.audio, *ins)
    want = m4.m4mb_audio(e.audio, *(t.double() for t in ins))
    for g, w64 in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w64.float())


def _engine(e, st, xb):
    """The float32 engine of the effect e on the block xb from the state
    st: a function of (ev, ev_lo, carry pair, env_ds, interp_y) -> its
    results, and those inputs, the envelopes of xb included."""
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    B = xb.shape[0]
    if hasattr(e, "_bp_plan"):  # matrix4: one lane
        _, (hi, lo) = iir.lti_blocked_df(e._bp_plan(B), st["bpc"], xb)
        env_ds = m4.m4_env_f32(hi, lo, st["env_m"], st["env_m_lo"], e.g_env)[2][None]
        lanes = [{k: v[None] for k, v in st[k2].items()} for k2 in ("ev", "ev_lo")]
        ins = (*lanes, st["bg_cs"][None], st["bg_cs_lo"][None], env_ds, st["interp_y"][None])
        return (lambda *a: m4.m4_event_f32(e.ctl, *a, 0, False)), ins, 1
    _, s_pre = e._cascade("fsh", st["fshape_m"].reshape(2, 2, 2), xb)
    _, (hi, lo) = iir.lti_blocked_df(e._bank_plan(B), st["bank"]["fused"], s_pre.repeat(1, 13))
    env_ds = m4.m4mb_env_f32(hi.view(B, 13, 2), lo.view(B, 13, 2), st["env_m"], st["env_m_lo"],
                             e.g_env)[2]
    ins = (st["ev"], st["ev_lo"], st["ev_thresh"], st["ev_thresh_lo"], env_ds, st["interp_y"])
    return (lambda *a: m4.m4mb_event_f32(e.ctl, *a, 0, False)), ins, 0


@pytest.mark.parametrize("spec", SPECS)
def test_f32_coefficient_sets_do_not_depend_on_the_block(spec):
    """The per-tick values are rounded to float32 before the insert, so the
    coefficient set a block carries (interp_c) is the one the next block
    would have computed: the float32 engine over 128 ticks in one call, and
    in two calls of 64 with the state split to (hi, lo) pairs between them,
    gives the same coefficient sets, window, display values and decisions.
    For matrix4 the whole float32 step does not depend on the block either
    (blocks 2048 and 4096 over 4096 frames); matrix4_mb's fshape state is
    rounded to float32 between blocks, as dsp_tpu's float32 state holds it,
    and its engines carry that rounding."""
    e, st, xb = _warm(spec, block=4096, blocks=2)
    run, ins, axis = _engine(e, st, xb)
    ev, ev_lo, c, c_lo, env_ds, iy = ins
    whole = run(*ins)
    half = env_ds.shape[1 if axis else 0] // 2
    first = run(ev, ev_lo, c, c_lo, env_ds.narrow(axis, 0, half), iy)
    second = run(*first[:4], env_ds.narrow(axis, half, half), first[5])
    ics = torch.cat([first[4], second[4]], dim=axis)
    assert whole[4].dtype == torch.float32 and torch.equal(whole[4], ics)
    assert torch.equal(whole[5], second[5])
    assert torch.equal(whole[6], torch.cat([first[6], second[6]], dim=axis))
    for k in ("ord_count", "diff_count", "early_count", "ignore_count", "t", "t_hold"):
        assert torch.equal(whole[0][k], second[0][k]), k
    assert int(whole[0]["diff_count"].sum()) + int(whole[0]["ord_count"].sum()) > 0
    if axis:  # matrix4: the whole step
        x = torch.as_tensor(transient_signal(0.2, seed=4)[:4096], dtype=torch.float32)
        ys = []
        for block in (2048, 4096):
            e, st = _port_effect(spec, torch.float32, block)
            out = []
            for b in range(4096 // block):
                st, y = e.step(st, x[b * block:(b + 1) * block])
                out.append(y)
            ys.append(torch.cat(out).double().numpy())
        err = worst_dbfs(*ys)
        print(f"{spec}: blocks 2048 and 4096 {err:.1f} dBFS apart")
        # the band-limit's (hi, lo) state and the audio states are rounded
        # to float32 between blocks
        assert err <= -140.0


# --- state: the float32 trees ------------------------------------------------


def _port(spec, dtype):
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    return CompiledChain(build_chain_from_string(spec, StreamInfo(FS, 2)), B, dtype=dtype,
                         device="cpu")


def _jax32(spec):
    """dsp_tpu's float32 chain: built (its load_state compiles nothing); its
    two-float32 step compiles at its first block."""
    import jax.numpy as jnp

    from dsp_tpu.chain import CompiledChain, build_chain_from_string
    from dsp_tpu.core.types import StreamInfo

    return CompiledChain(build_chain_from_string(spec, StreamInfo(FS, 2)), B, dtype=jnp.float32)


@pytest.mark.parametrize("spec", SPECS)
def test_f32_state_tree_is_dsp_tpus(spec, tmp_path):
    """The port's float32 state (state_for_block through CompiledChain) has
    dsp_tpu's float32 tree: the same treedef string, leaf shapes and dtypes
    (bpc, the *_lo leaves, every float leaf float32). Its save_state writes
    that tree, and dsp_tpu's float32 CompiledChain loads the checkpoint."""
    import jax

    from dsp_tpu_torch.convert import flatten_states

    cc, jc = _port(spec, torch.float32), _jax32(spec)
    leaves, treedef = flatten_states(cc.states)
    jleaves, jtree = jax.tree_util.tree_flatten(jc.states)
    assert treedef == str(jtree)
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in leaves]
    assert got == [(tuple(np.shape(a)), str(np.asarray(a).dtype)) for a in jleaves]
    st = next(s for s in cc.states if isinstance(s, dict) and "ev_lo" in s)
    assert ("bpc" in st) == (spec == "matrix4 -6")
    assert all(t.dtype == torch.float32 for t in flatten_states(st["ev_lo"])[0])
    cc.run_block(split_signal(B))
    ckpt = tmp_path / "state.npz"
    cc.save_state(str(ckpt))
    with np.load(ckpt) as z:
        assert str(z["__treedef__"]) == str(jtree)
        assert {str(z[k].dtype) for k in z.files if k.startswith("leaf_")} == {
            "float32", "bool", "int64"}
    jc.load_state(str(ckpt))


# --- K19: the float64 registers compute dfx's functions ------------------------


def test_float64_registers_compute_dfx():
    """dsp_tpu's two-float32 scalar functions (dfx.py: division, sqrt, sin,
    cos, tan, exp, atan_pos) on seeded (hi, lo) pairs against torch float64
    on hi + lo, the arithmetic the float32 kernels' registers do: within
    the tolerances tests/test_dfx.py holds dfx to against numpy float64."""
    import jax.numpy as jnp

    from dsp_tpu.ops import dfx

    rng = np.random.default_rng(19)

    def pair(v):
        hi = v.astype(np.float32)
        return dfx.DF(jnp.asarray(hi), jnp.asarray((v - hi).astype(np.float32))), \
            torch.as_tensor(hi.astype(np.float64) + (v - hi).astype(np.float32))

    def df_val(d):
        return np.asarray(d.hi, np.float64) + np.asarray(d.lo, np.float64)

    mag = np.exp(rng.uniform(np.log(1e-12), np.log(1e2), 4096)) * rng.choice([-1.0, 1.0], 4096)
    a, ta = pair(mag)
    b, tb = pair(np.exp(rng.uniform(np.log(1e-12), np.log(1e2), 4096)))
    ang, tang = pair(rng.uniform(-3.3, 3.3, 4096))
    e, te = pair(rng.uniform(-12.0, 3.0, 4096))
    r, tr = pair(np.exp(rng.uniform(np.log(1e-12), np.log(1e12), 4096)))
    tan_ok = np.abs(np.cos(tang.numpy())) > 0.3
    cases = {  # name: (dfx value, torch float64 value, rtol, atol) as test_dfx.py
        "div": (df_val(a / b), (ta / tb).numpy(), 1e-13, 0.0),
        "sqrt": (df_val(dfx.sqrt(b)), torch.sqrt(tb).numpy(), 1e-13, 0.0),
        "sin": (df_val(dfx.sin(ang)), torch.sin(tang).numpy(), 0.0, 3e-14),
        "cos": (df_val(dfx.cos(ang)), torch.cos(tang).numpy(), 0.0, 3e-14),
        "tan": (df_val(dfx.tan(ang))[tan_ok], torch.tan(tang).numpy()[tan_ok], 1e-11, 1e-13),
        "exp": (df_val(dfx.exp(e)), torch.exp(te).numpy(), 5e-13, 0.0),
        "atan_pos": (df_val(dfx.atan_pos(r)), torch.atan(tr).numpy(), 2e-13, 1e-16),
    }
    for name, (got, want, rtol, atol) in cases.items():
        err = np.abs(got - want)
        print(f"{name}: max |diff| {err.max():.2e}, "
              f"{float(np.max(err / np.maximum(np.abs(want), 1e-300))):.2e} relative")
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
