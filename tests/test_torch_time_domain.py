"""Slice C of dsp_tpu_torch against dsp_tpu, on the CPU in float64: jax's
threefry, noise, dither, stats, levels and delay.

The port's wrappers run their plain versions here (ops/time_domain.py,
ops/iir.py). dsp_tpu draws its noise from jax.random's threefry, and the
port reproduces it bit for bit (core/prng.py), so noise and dither are held
equal, not by their spectra. Seeds come from numpy's global generator, as
both packages draw them: each test seeds it alike before each package builds
its chain.

Tolerances and why:
* threefry keys and uniforms, noise, dither outputs and keys: equal. The
  port takes dsp_tpu's arithmetic, FMAs where XLA:CPU fuses them included.
  The dither's error history is held to 1e-15 absolute (1e-11 of a 12-bit
  step): XLA:CPU sums the 9-tap feedback dot in an order of its own when
  all 9 taps are nonzero (wan9), so its errors differ in the last bits,
  too little to move a quantized output.
* stats: min, max, peak, peak count and frame equal (exact comparisons in
  both); the printed table equal character for character. The sums are
  taken in another order, so they are held to 1e-12 relative only through
  the table's 8 printed decimals.
* levels: the meters to 1e-12 relative (a serial recurrence here, an
  associative scan there: the same function, summed in another order);
  the printed meter line equal.
* delay: -280 dBFS, the chain limit of torch_parity (Thiran sections on
  another scan, modulator knots and taps summed in another order).
"""

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import CHAIN_LIMIT_DBFS, FS, jax_chain, port_chain, read_wav, stereo_signal, worst_dbfs, write_wav

SEED = 4321


def _seeded(make, spec, block, channels=2, seed=SEED):
    np.random.seed(seed)
    return make(spec, block, channels)


def _both(spec, block, x, channels=2):
    t = _seeded(port_chain, spec, block, channels)
    j = _seeded(jax_chain, spec, block, channels)
    return t, j, t.process_array(x), np.asarray(j.process_array(x))


def _leaves(t, j):
    import jax

    from dsp_tpu_torch.convert import flatten_states, states_to_numpy

    assert flatten_states(t.states)[1] == str(jax.tree_util.tree_structure(j.states))
    return states_to_numpy(t.states), [np.asarray(a) for a in jax.tree_util.tree_leaves(j.states)]


# --- threefry ----------------------------------------------------------------


def test_threefry_is_partitionable():
    """The port reproduces jax's partitionable threefry; a changed default
    would change dsp_tpu's numbers and must fail here first."""
    import jax

    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 1234, (1 << 30) - 1, (1 << 40) + 7])
def test_prng_key_and_split_match_jax(seed):
    import jax

    from dsp_tpu_torch.core import prng

    key = prng.prng_key(seed)
    jkey = np.asarray(jax.random.PRNGKey(seed))
    assert key.dtype == torch.uint32 and tuple(key.shape) == (2,)
    np.testing.assert_array_equal(key.numpy(), jkey)
    for n in (2, 3, 7):
        np.testing.assert_array_equal(prng.split(key, n).numpy(), np.asarray(jax.random.split(jkey, n)))
    k0, k1 = prng.split(key, 2)
    np.testing.assert_array_equal(prng.split(k1, 3).numpy(), np.asarray(jax.random.split(jax.random.split(jkey)[1], 3)))


@pytest.mark.parametrize("shape", [(1,), (7,), (2048, 2), (1000, 3), (4, 6, 2, 1), (2, 6, 2, 2)])
@pytest.mark.parametrize("maxval", [float(0x7FFFFFFF), 1.0])
def test_uniform_f64_matches_jax(shape, maxval):
    import jax
    import jax.numpy as jnp

    from dsp_tpu_torch.core import prng

    for seed in (5, 987654):
        key = prng.split(prng.prng_key(seed), 3)[1]
        jkey = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
        u = prng.uniform_f64(key, shape, maxval)
        ju = np.asarray(jax.random.uniform(jkey, shape, dtype=jnp.float64, maxval=maxval))
        assert u.dtype == torch.float64 and tuple(u.shape) == shape
        np.testing.assert_array_equal(u.numpy(), ju)


def test_threefry2x32_known_answer():
    """The Random123 known-answer vector of threefry2x32 (20 rounds), as
    jax's own tests hold it."""
    from dsp_tpu_torch.core.prng import threefry2x32

    x0, x1 = threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)
    assert (int(x0), int(x1)) == (0xC4923A9C, 0x483DF7A0)


# --- K18-noise ------------------------------------------------------------


@pytest.mark.parametrize("spec", ["noise -60", ":1 noise 12b", "noise -20 :0 noise 8b"])
@pytest.mark.parametrize("block", [2048, 1000])
def test_noise_matches_dsp_tpu_exactly(spec, block):
    x = stereo_signal(0.5, seed=block)
    t, j, y_t, y_j = _both(spec, block, x)
    np.testing.assert_array_equal(y_t, y_j)
    for a, b in zip(*_leaves(t, j)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_noise_step_with_a_carried_key():
    """The wrapper against NoiseEffect.step directly, from a key a stream
    has advanced, on one selected channel of three."""
    import jax.numpy as jnp

    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.noise import NoiseEffect as JNoise
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.noise import NoiseEffect

    sel = np.array([False, True, False])
    t = NoiseEffect("noise", StreamInfo(FS, 3), sel, 3e-4, seed=77)
    j = JNoise("noise", JStream(FS, 3), sel, 3e-4, seed=77)
    kt, kj = torch.as_tensor(t.state0()), jnp.asarray(j.state0())
    rng = np.random.default_rng(3)
    for B in (512, 1, 777):
        x = rng.standard_normal((B, 3))
        kt, yt = t.step(kt, torch.as_tensor(x))
        kj, yj = j.step(kj, jnp.asarray(x))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))


# --- K15: dither -------------------------------------------------------------

SHAPES = ["flat", "sloped", "sloped2", "lipshitz", "wan3", "wan9"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", [2048, 1000])
def test_dither_fixed_bits_matches_dsp_tpu_exactly(shape, block):
    x = stereo_signal(0.4, seed=len(shape))
    t, j, y_t, y_j = _both(f"dither {shape} 12", block, x)
    np.testing.assert_array_equal(y_t, y_j)
    assert np.array_equal(y_t, np.round(y_t * 2048) / 2048)  # on the 12-bit grid
    (eh_t, key_t, nprev_t), (eh_j, key_j, nprev_j) = _leaves(t, j)
    np.testing.assert_array_equal(key_t, key_j)
    np.testing.assert_array_equal(nprev_t, nprev_j)
    np.testing.assert_allclose(eh_t, eh_j, rtol=0, atol=1e-15)


@pytest.mark.parametrize("shape", SHAPES)
def test_dither_auto_bits_match_dsp_tpu_exactly(shape):
    """'auto' bits, set by the application (chain_set_dither_params, 16 bits
    as for s16 output), on one channel; the other passes unchanged."""
    from dsp_tpu.chain.chain import chain_set_dither_params as jset
    from dsp_tpu_torch.chain.chain import chain_set_dither_params

    spec = f"gain -2 :1 dither {shape}"
    x = stereo_signal(0.4, seed=11)
    t = _seeded(port_chain, spec, 2048)
    j = _seeded(jax_chain, spec, 2048)
    # the effects' states were drawn at construction; the params change now
    assert chain_set_dither_params(t.chain, 16, True) is False
    assert jset(j.chain, 16, True) is False
    y_t, y_j = t.process_array(x), np.asarray(j.process_array(x))
    np.testing.assert_array_equal(y_t, y_j)
    assert np.array_equal(y_t[:, 1], np.round(y_t[:, 1] * 32768) / 32768)
    assert not np.array_equal(y_t[:, 0], np.round(y_t[:, 0] * 32768) / 32768)


def test_dither_step_from_a_carried_state():
    """tpdf_dither against DitherEffect.step from a state with history
    (error feedback, sloped noise carry), shaped and sloped2."""
    import jax.numpy as jnp

    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.dither import DitherEffect as JDither
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.dither import DitherEffect

    rng = np.random.default_rng(8)
    for shape in ("wan9", "sloped2"):
        args = ("dither", None, np.ones(2, dtype=bool), shape, 10.0, 10, False, False, 99)
        t = DitherEffect(args[0], StreamInfo(FS, 2), *args[2:])
        j = JDither(args[0], JStream(FS, 2), *args[2:])
        st = {k: np.asarray(v) for k, v in t.state0().items()}
        st["ehist"] = rng.standard_normal((9, 2)) * 1e-4
        st["nprev"] = rng.uniform(0, 0x7FFFFFFF, 2)
        st_t = {k: torch.as_tensor(v) for k, v in st.items()}
        st_j = {k: jnp.asarray(v) for k, v in st.items()}
        for B in (300, 1):
            x = rng.standard_normal((B, 2)) * 0.2
            st_t, y_t = t.step(st_t, torch.as_tensor(x))
            st_j, y_j = j.step(st_j, jnp.asarray(x))
            np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
            np.testing.assert_array_equal(st_t["key"].numpy(), np.asarray(st_j["key"]))
            np.testing.assert_array_equal(st_t["nprev"].numpy(), np.asarray(st_j["nprev"]))
            np.testing.assert_allclose(st_t["ehist"].numpy(), np.asarray(st_j["ehist"]),
                                       rtol=0, atol=1e-15)


# --- K16: stats ----------------------------------------------------------------


def _stats_table(capsys, cc):
    capsys.readouterr()
    cc.host_finish()
    return capsys.readouterr().err


def _stats_effect(cc):
    return next(e for e in cc._runtime_effects if e.name == "stats")


def _end_peak_input():
    """dsp_tpu's stats_end_peak case (test_ref_diff.py:248): sgen
    delta:offset=510S+0.0117, a unit impulse at frame 510 of 516, mono."""
    from dsp_tpu_torch.core.parse import parse_len

    n = parse_len("0.0117", FS)
    x = np.zeros((n, 1))
    x[510, 0] = 1.0
    return x


STATS_CASES = {
    "plain": ("gain -3 stats", 2),
    "plain_ref": ("gain -3 stats 6", 2),
    "plain_width": (":1 stats -w 40", 2),
    "interp": ("gain -3 stats -i", 2),
    "interp_selected": (":1 stats -i", 2),
    "end_peak": ("gain -0.2 stats -i", 1),
}


@pytest.mark.parametrize("case", list(STATS_CASES))
@pytest.mark.parametrize("block", [2048, 1000])
def test_stats_table_and_state_match_dsp_tpu(case, block, capsys):
    """The input ends inside a block, so set_valid_frames puts the limit
    there; the -i tables include the end-of-stream flush."""
    spec, channels = STATS_CASES[case]
    if case == "end_peak":
        x = _end_peak_input()
    else:
        x = stereo_signal(0.6, seed=block)[:26000 + block // 7]
        x = np.round(x * 32768) / 32768  # quantized: peaks tie, counts above 1
    t, j, y_t, y_j = _both(spec, block, x, channels)
    np.testing.assert_array_equal(y_t, y_j)  # stats passes its input through
    table_t = _stats_table(capsys, t)
    table_j = _stats_table(capsys, j)
    assert "Peak count" in table_t
    assert table_t == table_j
    ft, fj = _stats_effect(t)._final, _stats_effect(j)._final
    for k in ("min", "max", "peak", "peak_count", "peak_frame", "samples"):
        np.testing.assert_array_equal(ft[k], fj[k])
    if case == "end_peak":
        assert int(ft["peak_frame"][0]) >= 500  # found by the flush


def test_stats_step_from_a_carried_state():
    """stats_step against StatsEffect.step in both modes, from a carried
    state with a limit inside the block and an exact peak tie."""
    import jax.numpy as jnp

    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.stats import StatsEffect as JStats
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.stats import StatsEffect

    rng = np.random.default_rng(12)
    for interp in (False, True):
        t = StatsEffect("stats", StreamInfo(FS, 2), np.ones(2, dtype=bool), None, 80, interp)
        j = JStats("stats", JStream(FS, 2), np.ones(2, dtype=bool), None, 80, interp)
        st_t = {k: torch.as_tensor(v) for k, v in t.state0().items()}
        st_j = {k: jnp.asarray(v) for k, v in j.state0().items()}
        for blk, B in enumerate((700, 700, 700)):
            x = np.round(rng.standard_normal((B, 2)) * 0.3 * 256) / 256
            x[B // 2] = [1.75, -1.75]  # a peak that later blocks tie
            if blk == 2:
                st_t = t.set_valid_limit(st_t, 1400 + 333)
                st_t["limit"] = torch.as_tensor(st_t["limit"])
                st_j = j.set_valid_limit(st_j, 1400 + 333)
            st_t, _ = t.step(st_t, torch.as_tensor(x))
            st_j, _ = j.step(st_j, jnp.asarray(x))
            for k in st_j:
                a, b = st_t[k].numpy(), np.asarray(st_j[k])
                assert a.shape == b.shape and a.dtype == b.dtype, k
                if k in ("sum", "sum_sq"):
                    np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=k)
        assert int(st_t["samples"]) == 1733
        if not interp:
            assert int(st_t["peak_count"][0]) == 2  # blocks 0 and 1; 2 ends before its tie


# --- K17: levels ---------------------------------------------------------------


@pytest.mark.parametrize("spec", ["levels", ":1 levels -t 0.05"])
@pytest.mark.parametrize("block", [2048, 1000])
def test_levels_match_dsp_tpu(spec, block):
    x = stereo_signal(0.5, seed=block)
    t, j, y_t, y_j = _both(spec, block, x)
    np.testing.assert_array_equal(y_t, y_j)
    lt, lj = _leaves(t, j)
    for a, b in zip(lt, lj):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    et = next(e for e in t._runtime_effects if e.name == "levels")
    ej = next(e for e in j._runtime_effects if e.name == "levels")
    try:
        st_t = t.states[t._runtime_effects.index(et)]
        st_j = dict(j.states[j._runtime_effects.index(ej)])
        et.host_update(st_t)
        ej.host_update(st_j)
        assert [s.text for s in et._statuslines] == [s.text for s in ej._statuslines]
        assert et._statuslines[0].text.startswith("levels: channel")
        assert not st_t["block_peak"].any()  # zeroed on its device after the render
    finally:
        et.host_finish(None)
        ej.host_finish(None)


# --- delay (K2 sections, K14 modulation) --------------------------------------

DELAYS = [
    "delay 10",
    ":1 delay 2.5m",
    "delay -f 0.37m",
    "delay -f12 5.3S",
    ":0 delay -f2 1.3S :1 delay -f 7.77S",
    "delay -m 0.5m -q 0 10m",
    "delay -m 0.5m 10m",
    "delay -m 0.5m -q 2 10m",
    "delay -M 0.5m -q 0 10m",
    "delay -M 0.3m -q 1 -b 40 3m",
    "delay -M 0.5m -q 2 10m",
]


@pytest.mark.parametrize("spec", DELAYS)
@pytest.mark.parametrize("block", [2048, 1000])
def test_delay_matches_dsp_tpu(spec, block):
    x = stereo_signal(0.4, seed=block)
    t, j, y_t, y_j = _both(spec, block, x)
    assert y_t.shape == y_j.shape
    assert worst_dbfs(y_t, y_j) <= CHAIN_LIMIT_DBFS


def test_mod_delay_step_from_a_carried_state():
    """mod_delay against ModDelayEffect.step from a state mid-stream: a
    phase, a knot window and a line that are not zero; dsp_tpu's step runs
    as its chain runs it, in a jitted lax.scan (here over two blocks of each
    size), whose FMAs the port writes out."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.delay import ModDelayEffect as JMod
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.delay import ModDelayEffect

    rng = np.random.default_rng(21)
    for qual, mono in ((0, False), (1, True), (2, False)):
        args = ("delay", None, np.ones(2, dtype=bool), 30.0, 900.0, mono, qual, 555)
        t = ModDelayEffect(args[0], StreamInfo(FS, 2), *args[2:])
        j = JMod(args[0], JStream(FS, 2), *args[2:])
        st = {k: np.asarray(v) for k, v in t.state0().items()}
        st["buf"] = rng.standard_normal(st["buf"].shape) * 0.3
        st["y"] = rng.standard_normal(st["y"].shape) * 0.1
        st["t"] = np.float64(0.6180339887)
        st_t = {k: torch.as_tensor(v) for k, v in st.items()}
        st_j = {k: jnp.asarray(v) for k, v in st.items()}
        run_j = jax.jit(lambda s, xs: jax.lax.scan(j.step, s, xs))
        for B in (512, 33):
            xs = rng.standard_normal((2, B, 2)) * 0.3
            st_j, ys_j = run_j(st_j, jnp.asarray(xs))
            for x, y_j in zip(xs, ys_j):
                st_t, y_t = t.step(st_t, torch.as_tensor(x))
                assert worst_dbfs(y_t.numpy(), np.asarray(y_j)) <= CHAIN_LIMIT_DBFS
            np.testing.assert_array_equal(st_t["key"].numpy(), np.asarray(st_j["key"]))
            np.testing.assert_array_equal(st_t["buf"].numpy(), np.asarray(st_j["buf"]))
            for k in ("y", "t"):
                np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]), rtol=0, atol=1e-14)


def test_delay_sections_run_on_the_scan_kernel_wrapper(monkeypatch):
    """The Thiran sections go through iir.biquad_scan (K2 on the card)."""
    from dsp_tpu_torch.ops import iir

    calls = []
    orig = iir.biquad_scan
    monkeypatch.setattr(iir, "biquad_scan", lambda *a: calls.append(1) or orig(*a))
    port_chain("delay -f12 5.3S", 1000).process_array(stereo_signal(0.05))
    assert calls


# --- the slice as a whole: the delivery chain through both CLIs ---------------


@pytest.mark.parametrize("chain", [
    "gain -1 :1 delay -f 0.37m : dither lipshitz stats -i",
    "gain -1 dither lipshitz stats -i",
])
def test_delivery_chain_cli_s16_bytes_equal(chain, tmp_path, monkeypatch, capsys):
    """A CD master to s16 through dsp and dsp-torch: the same file bytes and
    the same stats table. With the delay's integer part an align effect
    follows the dither, and both CLIs then add their app-level dither too;
    without it the dither effect alone dithers."""
    from dsp_tpu.cli.main import main as dsp
    from dsp_tpu_torch.cli.main import main as dsp_torch

    # both CLIs set their package's log level for the process: -v must not
    # outlast the test (matrix4 turns its status bars on at verbose)
    from dsp_tpu.core import log as jax_log
    from dsp_tpu_torch.core import log as torch_log

    monkeypatch.setattr(jax_log, "_level", jax_log._level)
    monkeypatch.setattr(torch_log, "_level", torch_log._level)
    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cpu")
    src = tmp_path / "in.wav"
    write_wav(src, stereo_signal(1.5, seed=3)[:66000])
    out, tables = {}, {}
    for name, main in (("torch", dsp_torch), ("jax", dsp)):
        np.random.seed(SEED)
        out[name] = tmp_path / f"{name}.wav"
        capsys.readouterr()
        assert main(["-q", "-v", str(src), "-o", "-e", "s16", str(out[name]), *chain.split()]) == 0
        err = capsys.readouterr().err
        tables[name] = err[err.index("Channel "):]
        assert ("auto dither on (effect)" in err) == ("delay" not in chain)
    assert out["torch"].read_bytes() == out["jax"].read_bytes()
    assert tables["torch"] == tables["jax"]
    from dsp_tpu_torch.chain import build_chain_from_args
    from dsp_tpu_torch.chain.chain import expected_out_frames
    from dsp_tpu_torch.core.types import StreamInfo

    c = build_chain_from_args(chain.split(), StreamInfo(FS, 2))
    y = read_wav(out["torch"])
    assert y.shape == (expected_out_frames(c, 66000) - c.output_discard, 2)
    assert np.array_equal(y, np.round(y * 32768) / 32768)


@pytest.mark.parametrize("spec", ["delay -M 0.5m -q 2 10m noise -90 dither sloped2 16 stats levels"])
@pytest.mark.parametrize("block", [2048, 1000])
def test_modulated_chain_matches_dsp_tpu(spec, block, capsys):
    x = stereo_signal(0.6, seed=block)
    t, j, y_t, y_j = _both(spec, block, x)
    assert y_t.shape == y_j.shape
    assert worst_dbfs(y_t, y_j) <= CHAIN_LIMIT_DBFS
    assert _stats_table(capsys, t) == _stats_table(capsys, j)
