"""A run of per-sample biquads in one launch (iir.biquad_scan_run and
biquad_scan_run_df, csrc/biquad_scan.cu dsp_biquad_scan_run) and the FDL
multiply-accumulate's plain version, on the CPU:

* the run's plain version bit-equal to the n separate plain calls it
  replaces, in its four forms (K2 float64 with a single or a (hi, lo)
  state, K3 with a single or a (hi, lo) float32 state), with the states
  in their owners' layouts;
* the flagship at -b 1000 (six adjacent per-sample biquads) through the
  port in both dtypes against dsp_tpu float64, at the limits the existing
  flagship tests use, with one run call a block and the chain's runtime
  effects, names and state structure unchanged;
* matrix4_mb's fshape and inverse fshape cascades through the run, each
  state in its own layout, bit-equal to the two calls and the stack and
  transposed copies they replace;
* fdl_mac's plain versions against dsp_tpu's concatenate-then-sum
  (dsp_tpu/ops/fft_conv.py:99, :145-151) in both dtypes.
"""

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import CHAIN_LIMIT_DBFS, FLAGSHIP, FS, jax_chain, port_chain, stereo_signal, worst_dbfs
from dsp_tpu_torch.ops import fft_conv as fc
from dsp_tpu_torch.ops import iir

# (label, dtype of the samples and states, (hi, lo) states)
FORMS = [("f64", torch.float64, False), ("f64 pair", torch.float64, True),
         ("df1", torch.float32, False), ("df", torch.float32, True)]


def _biquads(n):
    """The coupled form of n of the flagship's kind of biquads (peaking
    filters from 30 Hz up, a highpass among them), stereo: A [n, 2, 2, 2],
    Bv [n, 2, 2], c0 [n, 2] float64."""
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    words = " ".join("highpass 30 0.7071" if s == 1 else f"eq {40.0 * 3.1 ** s:.1f} 0.8 "
                     f"{3.0 if s % 2 else -2.0}" for s in range(n))
    effects = build_chain_from_string(words, StreamInfo(FS, 2)).effects
    return tuple(torch.as_tensor(np.stack([getattr(e, k) for e in effects]))
                 for k in ("_ss_A", "_ss_Bv", "_ss_c0"))


def _one_stage(dtype, pair):
    if dtype == torch.float32:
        return iir.biquad_scan_df_ref
    return iir.biquad_scan_pair_ref if pair else iir.biquad_scan_ref


@pytest.mark.parametrize("B", [100, 1000, 1056])
@pytest.mark.parametrize("n", [2, 3, 6])
@pytest.mark.parametrize("label,dtype,pair", FORMS, ids=[f[0] for f in FORMS])
def test_run_is_the_separate_calls(label, dtype, pair, n, B):
    """biquad_scan_run (here its plain version) equals, bit for bit, n
    separate plain calls of its form in order. Single states sit as
    matrix4_mb's inverse fshape keeps them ([C, n, 2], stage s at [:, s],
    written into views of a new tensor); pairs as the chain keeps each
    biquad's [2, C, 2]."""
    A, Bv, c0 = _biquads(n)
    rng = np.random.default_rng(n * B)
    x = torch.as_tensor(rng.standard_normal((B, 2)) * 0.3, dtype=dtype)
    if pair:
        raw = rng.standard_normal((n, 2, 2, 2)) * 1e-2
        raw[:, 1] *= 1e-9  # a small lo part, as a state handed over from dsp_tpu may carry
        states = [torch.as_tensor(r, dtype=dtype) for r in raw]
        new, out = None, None
    else:
        kept = torch.as_tensor(rng.standard_normal((2, n, 2)) * 1e-2, dtype=dtype)
        states, new = kept.unbind(1), torch.empty_like(kept)
        out = new.unbind(1)
    ends, y = iir.biquad_scan_run(A, Bv, c0, states, x, out=out)
    want, xs = [], x
    for s in range(n):
        st, xs = _one_stage(dtype, pair)(A[s], Bv[s], c0[s], states[s], xs)
        want.append(st)
    assert y.dtype == dtype and torch.equal(y, xs)
    assert all(torch.equal(e, w) for e, w in zip(ends, want))
    if new is not None:
        assert all(e.data_ptr() == o.data_ptr() for e, o in zip(ends, out))
        assert torch.equal(new, torch.stack(want, dim=1))


@pytest.mark.parametrize("wrapper", ["biquad_scan_run", "biquad_scan_run_df"])
def test_run_takes_no_plain_path_off_the_cpu(wrapper):
    """Only a CPU tensor reaches the plain version: a meta tensor (no
    kernel) raises, and nothing is counted."""
    dtype = torch.float32 if wrapper.endswith("df") else torch.float64
    A, Bv, c0 = (torch.empty(s, dtype=torch.float64, device="meta")
                 for s in ((2, 2, 2, 2), (2, 2, 2), (2, 2)))
    states = [torch.empty((2, 2, 2), dtype=dtype, device="meta") for _ in range(2)]
    x = torch.empty((256, 2), dtype=dtype, device="meta")
    fn = getattr(iir, wrapper)
    before = fn.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fn(A, Bv, c0, states, x)
    assert fn.launches == before


def test_run_refuses_the_other_dtype():
    A, Bv, c0 = _biquads(2)
    x = torch.zeros((64, 2), dtype=torch.float64)
    with pytest.raises(TypeError):
        iir.biquad_scan_run(A, Bv, c0, [torch.zeros((2, 2), dtype=torch.float32)] * 2, x)
    with pytest.raises(TypeError):
        iir.biquad_scan_run_df(A.float(), Bv, c0, [torch.zeros((2, 2), dtype=torch.float32)] * 2,
                               x.float())


@pytest.fixture(scope="module")
def flagship_1000():
    """dsp_tpu float64's flagship at -b 1000 on half a second, its runtime
    effect names and state structure."""
    import jax

    x = stereo_signal(0.5, seed=1000)
    j = jax_chain(FLAGSHIP, 1000)
    y = np.asarray(j.process_array(x))
    names = "|".join(e.name for e in j._runtime_effects)
    return x, y, names, str(jax.tree_util.tree_structure(j.states))


# the limits of the existing flagship tests: test_torch_chain.py's
# CHAIN_LIMIT_DBFS in float64, test_torch_f32.py's pin against dsp_tpu
# float64 at -b 1000 in float32
FLAGSHIP_LIMITS = {torch.float64: CHAIN_LIMIT_DBFS, torch.float32: -125.0}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_flagship_1000_runs_its_biquads_in_one_call(dtype, flagship_1000, monkeypatch):
    """At -b 1000 K1 does not take the block, so the six biquads run per
    sample: as one biquad_scan_run call a block, none of them alone; the
    output within the flagship tests' limits of dsp_tpu float64; the
    runtime effects, names and state structure as before (a checkpoint
    still crosses: test_torch_state.py)."""
    from dsp_tpu_torch.chain import CompiledChain
    from dsp_tpu_torch.convert import flatten_states
    from dsp_tpu_torch.effects.biquad import BiquadEffect

    x, y_j, names, treedef = flagship_1000
    calls = {"run": 0, "step": 0, "alone": 0}
    run, step = iir.biquad_scan_run, CompiledChain._step

    def count(key, fn):
        def spy(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return spy

    monkeypatch.setattr(iir, "biquad_scan_run", count("run", run))
    monkeypatch.setattr(CompiledChain, "_step", count("step", step))
    monkeypatch.setattr(BiquadEffect, "step", count("alone", BiquadEffect.step))
    cc = port_chain(FLAGSHIP, 1000) if dtype == torch.float64 else CompiledChain(
        port_chain(FLAGSHIP, 1000).chain, 1000, dtype=dtype, device="cpu")
    assert [e.name for e in cc._runtime_effects].count("biquad(fused-cascade)") == 0
    assert [n for _, n in cc._steps] == [0, 6, 0, 0, 0]
    y = cc.process_array(x)
    assert y.shape == y_j.shape
    err = worst_dbfs(y, y_j)
    print(f"flagship -b 1000 {dtype}: {err:.1f} dBFS against dsp_tpu f64")
    assert err <= FLAGSHIP_LIMITS[dtype]
    assert calls["step"] > 0 and calls["run"] == calls["step"] and calls["alone"] == 0
    assert cc._effect_names() == names
    assert flatten_states(cc.states)[1] == treedef
    assert all(st.shape == (2, 2, 2) and st.dtype == dtype for st in cc.states[1:7])


@pytest.fixture(scope="module")
def mb_effect():
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    return build_chain_from_string("matrix4_mb -6", StreamInfo(FS, 2)).effects[1]


def _parent_cascade(e, tag, st, x):
    """matrix4_mb's cascade as it ran before the run: two
    biquad_scan_coupled calls on a contiguous copy of each stage's state,
    the end states stacked."""
    A, Bv, c0 = (torch.as_tensor(getattr(e, f"{tag}_{k}")) for k in ("A", "Bv", "c0"))
    out = []
    for s in range(2):
        s_end, x = iir.biquad_scan_coupled(A[s], Bv[s], c0[s], st[s].contiguous(), x)
        out.append(s_end)
    return torch.stack(out), x


@pytest.mark.parametrize("B", [1000, 2048])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_mb_cascades_equal_the_parents(dtype, B, mb_effect):
    """fshape_m [4, 2] and inv_fshape_m [n_sig, 2, 2] through _cascade (one
    run call, each state read and written in its own layout) equal, bit
    for bit, the parent's two calls with its reshape, transpose and
    copies."""
    e = mb_effect
    rng = np.random.default_rng(B)
    n_sig = e.audio.n_sig
    fsh = torch.as_tensor(rng.standard_normal((4, 2)) * 1e-2, dtype=dtype)
    inv = torch.as_tensor(rng.standard_normal((n_sig, 2, 2)) * 1e-2, dtype=dtype)
    pair = torch.as_tensor(rng.standard_normal((B, 2)) * 0.3, dtype=dtype)
    sig = torch.as_tensor(rng.standard_normal((B, n_sig)) * 0.3, dtype=dtype)

    new_f, y_f = e._cascade("fsh", fsh.reshape(2, 2, 2), pair)
    old_f, want_f = _parent_cascade(e, "fsh", fsh.reshape(2, 2, 2), pair)
    assert torch.equal(y_f, want_f) and torch.equal(new_f.reshape(4, 2), old_f.reshape(4, 2))
    new_i, y_i = e._cascade("inv", inv.transpose(0, 1), sig)
    old_i, want_i = _parent_cascade(e, "inv", inv.transpose(0, 1), sig)
    assert torch.equal(y_i, want_i)
    kept = new_i.transpose(0, 1)
    assert kept.is_contiguous() and torch.equal(kept, old_i.transpose(0, 1).contiguous())


def _dsp_tpu_mac(X, H, fdl, f32):
    """dsp_tpu's concatenate-then-sum: UpolsConv.step's FDL shift and MAC
    (dsp_tpu/ops/fft_conv.py:145-151, in complex64 under float32), or,
    with no delay line, OlsConv.step's product (:99)."""
    import jax.numpy as jnp

    rdt, cdt = (np.float32, jnp.complex64) if f32 else (np.float64, jnp.complex128)
    X, H = jnp.asarray(X, cdt), jnp.asarray(H, cdt)
    if fdl is None:
        return np.asarray(X * H[0]), None
    fdl = jnp.asarray(fdl)
    fdl_c = fdl[..., 0].astype(rdt) + 1j * fdl[..., 1].astype(rdt)
    f = jnp.concatenate([X[None].astype(cdt), fdl_c[:-1]], axis=0)
    Y = (f * H).sum(axis=0)
    return np.asarray(Y), np.asarray(jnp.stack([f.real, f.imag], axis=-1).astype(rdt))


@pytest.mark.parametrize("K", [1, 2, 15, 16, 32, 33])
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_fdl_mac_plain_is_dsp_tpus(f32, K):
    """fdl_mac_ref (fdl_mac_f32_ref) against dsp_tpu's concatenate-then-sum
    on seeded spectra (NB = 17, stereo): the shifted FDL equal; Y within
    K roundings of the terms' scale in the FDL's dtype (the sums run in
    another order; dsp_tpu's float32 in complex64, the port's in
    complex128)."""
    rng = np.random.default_rng(K)
    NB, C = 17, 2
    X = rng.standard_normal((NB, C)) + 1j * rng.standard_normal((NB, C))
    H = rng.standard_normal((K, NB, C)) + 1j * rng.standard_normal((K, NB, C))
    rdt = np.float32 if f32 else np.float64
    fdl = rng.standard_normal((K, NB, C, 2)).astype(rdt)
    mac = fc.fdl_mac_f32_ref if f32 else fc.fdl_mac_ref
    y, f = mac(torch.as_tensor(X), torch.as_tensor(H), torch.as_tensor(fdl))
    y_j, f_j = _dsp_tpu_mac(X, H, fdl, f32)
    assert f.dtype == (torch.float32 if f32 else torch.float64)
    np.testing.assert_array_equal(f.numpy(), f_j)
    scale = float(np.abs(np.concatenate([X[None], fdl[..., 0] + 1j * fdl[..., 1]])[:K] * H)
                  .sum(axis=0).max())
    tol = 4 * (K + 1) * np.finfo(rdt).eps * scale
    assert np.abs(y.numpy() - y_j).max() <= tol
    if K == 1:  # the overlap-save step: no delay line
        y1, none = mac(torch.as_tensor(X), torch.as_tensor(H))
        y1_j, _ = _dsp_tpu_mac(X, H, None, f32)
        assert none is None and np.abs(y1.numpy() - y1_j).max() <= tol
