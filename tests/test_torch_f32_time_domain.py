"""Slice J4 of dsp_tpu_torch against dsp_tpu float32, on the CPU: noise,
dither, the modulated delay, stats and levels in a float32 chain.

dsp_tpu runs as CompiledChain(..., dtype=jnp.float32), the port as
CompiledChain(..., dtype=torch.float32, device="cpu"), where every kernel
wrapper runs its plain PyTorch version. jax's float32 uniform draws other
bits than its float64 one (x0 ^ x1 of threefry2x32, 23 of them), so these
effects are held against dsp_tpu float32, not float64: their noise is not
the float64 noise rounded. Seeds come from numpy's global generator, as both
packages draw them: each test seeds it alike before each package builds its
chain. dsp_tpu's renders are made once, in module fixtures.

Tolerances and why:
* uniform_f32, noise, and the flat, sloped and sloped2 dither: equal, with
  the keys and the dither's error history and noise carry.
* lipshitz, wan3 and wan9: dsp_tpu float32's XLA:CPU sums the 9-tap
  feedback dot in an order that changes with the block size (an FMA chain
  for lipshitz at 2048, in order at 1000), and the port sums it in order.
  One rounding of the feedback flips a quantizer step, and the feedback
  then follows its own path: the outputs are held by the measured count of
  differing samples (pinned ~1.5x above the measurement) and by each
  differing sample being a few steps of the quantizer away.
* delay -m/-M: the draws, keys and phases equal. dsp_tpu float32's XLA:CPU
  contracts some of the knots' and the B-spline's operations into FMAs, and
  which ones changes with the fusion around them; the port rounds each on
  its own, so the knots and the modulation differ in their last bits
  (MOD_Z_ULPS) and a read position by as much. The port reads the line in
  float64 and rounds once, dsp_tpu in float32: the output is held within
  DELAY_F32_DBFS.
* stats: min, max, peak, peak count and frame and the -i estimator's state
  equal; the sums are taken in float64 from the float32 samples (dsp_tpu
  sums in float32), held to STATS_SUM_RTOL relative; the tables equal
  character for character. Against dsp_tpu float64's table: the peak count
  and frame equal, the printed levels within 0.001 dB.
* levels: the port scans in float64 and rounds each meter once; dsp_tpu
  float32 scans in float32, with g rounded to float32: held to LEVELS_RTOL
  relative, and to dsp_tpu float64's meters within 1e-6 relative (a few
  float32 ulps: the port's float32 meters are dsp_tpu's float64 ones
  rounded).
"""

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from test_torch_time_domain import _leaves, _stats_table
from torch_parity import FS, read_wav, stereo_signal, worst_dbfs, write_wav

SEED = 6789
F32 = torch.float32
# measured -105.3 to -113.3 dBFS a block of 2048 with the modulator at 30 Hz
DELAY_F32_DBFS = -96.0
MOD_Z_ULPS = 8  # measured at most 2
STATS_SUM_RTOL = 1e-6
LEVELS_RTOL = 1e-4  # measured 3.8e-5 (levels -t 0.05)
MODULATED = "delay -M 0.5m -q 2 10m noise -90 dither sloped2 16 stats levels"
DELIVERY = "gain -1 :1 delay -f 0.37m : dither lipshitz stats -i"


def _jax32(spec, block, fs=FS, channels=2):
    import jax.numpy as jnp

    from dsp_tpu.chain import CompiledChain, build_chain_from_string
    from dsp_tpu.core.types import StreamInfo

    np.random.seed(SEED)
    return CompiledChain(build_chain_from_string(spec, StreamInfo(fs, channels)), block,
                         dtype=jnp.float32)


def _port(spec, block, fs=FS, channels=2, dtype=F32):
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    np.random.seed(SEED)
    return CompiledChain(build_chain_from_string(spec, StreamInfo(fs, channels)), block,
                         dtype=dtype, device="cpu")


def _run_both(spec, block, x, fs=FS):
    """(port chain, dsp_tpu chain, port output, dsp_tpu output), float32
    both."""
    t, j = _port(spec, block, fs), _jax32(spec, block, fs)
    return t, j, t.process_array(x), np.asarray(j.process_array(x))


# --- jax's float32 uniform ----------------------------------------------------


@pytest.mark.parametrize("shape", [(1,), (7,), (2048, 2), (1000, 3), (4, 6, 2, 1), (2, 6, 2, 2)])
@pytest.mark.parametrize("maxval", [float(0x7FFFFFFF), 1.0])
def test_uniform_f32_matches_jax(shape, maxval):
    """Bit for bit, at sizes that are not multiples of 4 among them."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu_torch.core import prng

    for seed in (5, 987654, (1 << 40) + 3):
        key = prng.split(prng.prng_key(seed), 3)[1]
        jkey = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
        u = prng.uniform_f32(key, shape, maxval)
        ju = np.asarray(jax.random.uniform(jkey, shape, dtype=jnp.float32, maxval=maxval))
        assert u.dtype == F32 and tuple(u.shape) == shape
        np.testing.assert_array_equal(u.numpy().view(np.uint32), ju.view(np.uint32))


def test_uniform_f32_is_not_the_f64_draw_rounded():
    """jax's two dtypes draw different numbers from one key (the records
    once said otherwise): the float32 chain's noise is its own."""
    from dsp_tpu_torch.core import prng

    key = prng.prng_key(7)
    u32 = prng.uniform_f32(key, (4,), 0x7FFFFFFF).numpy()
    u64 = prng.uniform_f64(key, (4,), 0x7FFFFFFF).numpy()
    np.testing.assert_array_equal(u32, np.float32([1.4475971e9, 2.0929738e9, 6.5035162e8,
                                                   9.5339366e8]))
    assert not np.allclose(u32, u64.astype(np.float32), rtol=1e-3)


# --- K18-noise and K15 --------------------------------------------------------


@pytest.mark.parametrize("spec", ["noise -60", ":1 noise 12b", "noise -20 :0 noise 8b"])
@pytest.mark.parametrize("block", [2048, 1000])
def test_noise_f32_matches_dsp_tpu_exactly(spec, block):
    x = stereo_signal(0.3, seed=block)
    t, j, y_t, y_j = _run_both(spec, block, x)
    assert y_t.dtype == np.float64 and np.array_equal(y_t, y_t.astype(np.float32))
    np.testing.assert_array_equal(y_t, y_j)
    for a, b in zip(*_leaves(t, j)):
        np.testing.assert_array_equal(a, b)


# shape: (fs, {block: pinned count of differing samples, or 0 for equal}).
# One pin for every block of a shape: which order dsp_tpu's XLA:CPU takes
# for the feedback dot changes with the block size and the fusion around it

DITHERS = {
    "flat": (FS, {2048: 0, 1000: 0}),
    "sloped": (FS, {2048: 0, 1000: 0}),
    "sloped2": (FS, {2048: 0, 1000: 0}),
    # measured 0 (2048) and 5009 (1000) of 44100, at most 6 steps apart
    "lipshitz": (FS, {2048: 7500, 1000: 7500}),
    # measured 0 and 0
    "wan3": (48000, {2048: 7500, 1000: 7500}),
    # measured 2221 and 1950, at most 12 steps apart
    "wan9": (48000, {2048: 7500, 1000: 7500}),
}


@pytest.mark.parametrize("shape", list(DITHERS))
@pytest.mark.parametrize("block", [2048, 1000])
def test_dither_f32_matches_dsp_tpu(shape, block):
    """dither <shape> 12 on 0.5 s: the flat and sloped ones equal with
    their state; the ones with more than one feedback tap held by the count
    of samples that differ (see the module's notes)."""
    fs, pins = DITHERS[shape]
    x = stereo_signal(0.5, seed=block + 1)
    t, j, y_t, y_j = _run_both(f"dither {shape} 12", block, x, fs)
    step = 2.0 ** -11
    assert np.array_equal(y_t, np.round(y_t / step) * step)  # quantized to 12 bits
    n_diff = int((y_t != y_j).sum())
    lt, lj = _leaves(t, j)
    print(f"dither {shape} block {block}: {n_diff} of {y_t.size} samples differ, "
          f"at most {np.abs(y_t - y_j).max() / step:.0f} steps")
    if pins[block] == 0:
        np.testing.assert_array_equal(y_t, y_j)
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(a, b)
        return
    assert n_diff <= pins[block]
    assert np.abs(y_t - y_j).max() <= 16 * step
    np.testing.assert_array_equal(lt[2], lj[2])  # the key


def test_dither_f32_step_from_a_carried_state():
    """tpdf_dither_f32 against DitherEffect.step from a state with history,
    in float32, sloped and sloped2 (one feedback tap: the dot's order does
    not matter)."""
    import jax.numpy as jnp

    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.dither import DitherEffect as JDither
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.dither import DitherEffect

    rng = np.random.default_rng(4)
    for shape in ("sloped", "sloped2"):
        args = ("dither", None, np.ones(2, dtype=bool), shape, 10.0, 10, False, False, 99)
        t = DitherEffect(args[0], StreamInfo(FS, 2), *args[2:])
        j = JDither(args[0], JStream(FS, 2), *args[2:])
        st = {k: np.asarray(v) for k, v in t.state0().items()}
        st["ehist"] = (rng.standard_normal((9, 2)) * 1e-4).astype(np.float32)
        st["nprev"] = rng.uniform(0, 0x7FFFFFFF, 2).astype(np.float32)
        st_t = {k: torch.as_tensor(v) for k, v in st.items()}
        st_j = {k: jnp.asarray(v) for k, v in st.items()}
        for B in (300, 1):
            x = (rng.standard_normal((B, 2)) * 0.2).astype(np.float32)
            st_t, y_t = t.step(st_t, torch.as_tensor(x))
            st_j, y_j = j.step(st_j, jnp.asarray(x))
            assert y_t.dtype == F32
            np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
            for k in ("key", "nprev", "ehist"):
                np.testing.assert_array_equal(st_t[k].numpy(), np.asarray(st_j[k]), err_msg=k)


# --- K14: the modulated delay -------------------------------------------------

MOD_DELAYS = [
    ("delay -m 0.5m -q 0 -b 30 10m", 2048),
    ("delay -m 0.5m 10m", 1000),
    ("delay -m 0.5m -q 2 -b 30 10m", 2048),
    ("delay -M 0.5m -q 0 -b 30 10m", 1000),
    ("delay -M 0.3m -q 1 -b 40 3m", 2048),
    ("delay -M 0.5m -q 2 -b 30 10m", 1000),
]


@pytest.mark.parametrize("spec,block", MOD_DELAYS)
def test_mod_delay_f32_matches_dsp_tpu(spec, block):
    """On 0.7 s the modulator takes new knots (the window is no longer the
    zeros it started from: one knot at the default 1 Hz, ~40 at -b 30);
    the carried knots, phase, key and line equal dsp_tpu float32's, the
    output within DELAY_F32_DBFS."""
    x = stereo_signal(0.7, seed=block + 2)
    t, j, y_t, y_j = _run_both(spec, block, x)
    assert y_t.shape == y_j.shape
    err = worst_dbfs(y_t, y_j)
    print(f"{spec} block {block}: {err:.1f} dBFS")
    assert err <= DELAY_F32_DBFS
    i = next(i for i, e in enumerate(t._runtime_effects) if type(e).__name__ == "ModDelayEffect")
    st_t = {k: v.numpy() for k, v in t.states[i].items()}
    st_j = {k: np.asarray(v) for k, v in j.states[i].items()}
    assert st_t["y"].any()  # n_consumed > 0: new knots came in
    for k in ("key", "t"):
        assert st_t[k].dtype == st_j[k].dtype
        np.testing.assert_array_equal(st_t[k], st_j[k], err_msg=k)
    np.testing.assert_allclose(st_t["y"], st_j["y"], rtol=0, atol=MOD_Z_ULPS * 2.0 ** -24)
    assert worst_dbfs(st_t["buf"], st_j["buf"]) <= DELAY_F32_DBFS


@pytest.mark.parametrize("mono", [False, True])
def test_mod_noise_f32_is_dsp_tpu_f32s_modulator(mono):
    """mod_noise_f32_ref against dsp_tpu float32's _mod_noise_block, jitted,
    from a carried phase and knot window, over blocks whose phase crosses
    knots: the key and the phase bit for bit, the modulation z and the
    window within MOD_Z_ULPS of 1."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.delay import ModDelayEffect as JMod
    from dsp_tpu_torch.ops.time_domain import mod_noise_f32_ref

    rng = np.random.default_rng(8)
    j = JMod("delay", JStream(FS, 2), np.ones(2, dtype=bool), 30.0, 900.0, mono, 1, 555)
    lanes = 1 if mono else 2
    st = {"key": jnp.asarray(jax.random.PRNGKey(555)), "t": jnp.float32(0.618034),
          "y": jnp.asarray((rng.standard_normal((4, lanes)) * 0.1).astype(np.float32))}
    for B in (2048, 1000, 33):
        noise = jax.jit(lambda s: j._mod_noise_block(s, B, jnp.float32))
        z_j, st_j = noise(st)
        key, yk, t, z = mod_noise_f32_ref(*(torch.tensor(np.array(st[k])) for k in ("key", "y", "t")),
                                          B, j.step_size)
        z_j = np.asarray(z_j)[:, :lanes]
        assert z.dtype == F32 and 0.0 < float(z.min()) and float(z.max()) < 1.0
        print(f"B {B}: z {int((z.numpy() != z_j).sum())} of {z_j.size} differ, at most "
              f"{np.abs(z.numpy() - z_j).max() * 2 ** 24:.0f} ulps of 1")
        np.testing.assert_allclose(z.numpy(), z_j, rtol=0, atol=MOD_Z_ULPS * 2.0 ** -24)
        np.testing.assert_array_equal(key.numpy(), np.asarray(st_j["key"]))
        np.testing.assert_allclose(yk.numpy(), np.asarray(st_j["y"]), rtol=0,
                                   atol=MOD_Z_ULPS * 2.0 ** -24)
        np.testing.assert_array_equal(t.numpy(), np.asarray(st_j["t"]))
        st = dict(st_j)


# --- K16 and K17 ------------------------------------------------------------------


def _stats_final(cc):
    return next(e for e in cc._runtime_effects if e.name == "stats")._final


@pytest.fixture(scope="module")
def stats_runs():
    """dsp_tpu float32's and float64's stats tables and final states, for
    each case, rendered once; the input ends inside a block."""
    from torch_parity import jax_chain

    runs = {}
    for spec in ("gain -3 stats", "gain -3 stats -i"):
        for block in (2048, 1000):
            x = stereo_signal(0.5, seed=block)[:20000 + block // 7]
            x = np.round(x * 32768) / 32768  # quantized: peaks tie, counts above 1
            j = _jax32(spec, block)
            j.process_array(x)
            np.random.seed(SEED)
            j64 = jax_chain(spec, block)
            j64.process_array(x)
            runs[spec, block] = (x, j, j64)
    return runs


@pytest.mark.parametrize("spec", ["gain -3 stats", "gain -3 stats -i"])
@pytest.mark.parametrize("block", [2048, 1000])
def test_stats_f32_matches_dsp_tpu(spec, block, stats_runs, capsys):
    x, j, j64 = stats_runs[spec, block]
    t = _port(spec, block)
    t.process_array(x)
    table_t, table_j = _stats_table(capsys, t), _stats_table(capsys, j)
    table_64 = _stats_table(capsys, j64)
    assert "Peak count" in table_t
    assert table_t == table_j
    ft, fj = _stats_final(t), _stats_final(j)
    for k, v in fj.items():
        assert ft[k].dtype == v.dtype, k
        if k in ("sum", "sum_sq"):
            np.testing.assert_allclose(ft[k], v, rtol=STATS_SUM_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(ft[k], v, err_msg=k)
    # against float64: the same peak events, the levels within 0.001 dB
    rows_t = {r[:18]: r[18:].split() for r in table_t.splitlines() if r.strip()}
    rows_64 = {r[:18]: r[18:].split() for r in table_64.splitlines() if r.strip()}
    for row in ("Peak count      ", "Peak sample     ", "Samples         "):
        assert rows_t[row.ljust(18)] == rows_64[row.ljust(18)]
    for row in ("Peak level (dBFS)", "RMS level (dBFS)"):
        np.testing.assert_allclose(np.float64(rows_t[row.ljust(18)]),
                                   np.float64(rows_64[row.ljust(18)]), rtol=0, atol=1e-3)


@pytest.mark.parametrize("spec", ["levels", ":1 levels -t 0.05"])
@pytest.mark.parametrize("block", [2048, 1000])
def test_levels_f32_match_dsp_tpu(spec, block):
    from torch_parity import jax_chain

    x = stereo_signal(0.5, seed=block)
    t, j, y_t, y_j = _run_both(spec, block, x)
    np.testing.assert_array_equal(y_t, y_j)
    lt, lj = _leaves(t, j)
    for a, b in zip(lt, lj):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=LEVELS_RTOL, atol=0)
    j64 = jax_chain(spec, block)
    j64.process_array(x)
    for a, b in zip(lt, _leaves(t, j64)[1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


# --- the slice as a whole ----------------------------------------------------------


def test_delivery_chain_cli_s16_f32(tmp_path, monkeypatch, capsys):
    """The CD master to s16 through dsp and dsp-torch, both in float32 (the
    app-level dither stays host-side Park-Miller in float64 in both): the
    same frame count; s16 samples that differ only where the lipshitz
    feedback took another path, each by a few steps (dsp_tpu float32's
    feedback dot and its float32 Thiran delay on channel 1 round otherwise
    than the port's, and one rounding flips a step); the stats -i tables of
    the dithered signal the same row by row: channel 0 and the peak events
    equal, the levels within STATS_TABLE_DB."""
    import jax.numpy as jnp

    import dsp_tpu.config
    from dsp_tpu.cli.main import main as dsp
    from dsp_tpu_torch.cli.main import main as dsp_torch

    # both CLIs set their package's log level for the process: -v must not
    # outlast the test (matrix4 turns its status bars on at verbose)
    from dsp_tpu.core import log as jax_log
    from dsp_tpu_torch.core import log as torch_log

    monkeypatch.setattr(jax_log, "_level", jax_log._level)
    monkeypatch.setattr(torch_log, "_level", torch_log._level)
    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DSP_TPU_TORCH_DTYPE", "float32")
    monkeypatch.setattr(dsp_tpu.config._cfg, "_sample_dtype", jnp.dtype(jnp.float32))
    src = tmp_path / "in.wav"
    write_wav(src, stereo_signal(1.0, seed=3)[:44000])
    out, tables = {}, {}
    for name, main in (("torch", dsp_torch), ("jax", dsp)):
        np.random.seed(SEED)
        out[name] = tmp_path / f"{name}.wav"
        capsys.readouterr()
        assert main(["-q", "-v", str(src), "-o", "-e", "s16", str(out[name]), *DELIVERY.split()]) == 0
        err = capsys.readouterr().err
        tables[name] = err[err.index("Channel "):]
    y_t, y_j = read_wav(out["torch"]), read_wav(out["jax"])
    assert y_t.shape == y_j.shape
    n_diff = int((y_t != y_j).sum())
    print(f"delivery s16: {n_diff} of {y_t.size} samples differ, at most "
          f"{np.abs(y_t - y_j).max() * 32768:.0f} steps")
    assert n_diff <= DELIVERY_S16_PIN
    assert np.abs(y_t - y_j).max() <= 8 / 32768
    rows_t, rows_j = _table_rows(tables["torch"]), _table_rows(tables["jax"])
    assert rows_t.keys() == rows_j.keys()
    for row, v in rows_t.items():
        assert v[0] == rows_j[row][0], row  # channel 0: the gain only, and its dither
        if row in ("Minimum", "Maximum"):
            np.testing.assert_allclose(v, rows_j[row], rtol=0, atol=8 / 32768, err_msg=row)
        elif row == "DC offset":
            np.testing.assert_allclose(v, rows_j[row], rtol=0, atol=2e-8, err_msg=row)
        elif "(dB" in row:
            np.testing.assert_allclose(v, rows_j[row], rtol=0, atol=STATS_TABLE_DB, err_msg=row)
        else:
            assert v == rows_j[row], row


STATS_TABLE_DB = 0.01  # measured 0.0005 dB (a peak 2 steps apart)


def _table_rows(table):
    """A stats table as {row label: [float per channel]}."""
    return {line[:18].strip(): [float(v) for v in line[18:].split()]
            for line in table.splitlines() if line.strip()}


DELIVERY_S16_PIN = 40000  # measured 27460 of 88034, at most 6 steps


@pytest.mark.parametrize("direction", ["dsp_tpu to the port", "the port to dsp_tpu"])
def test_modulated_f32_checkpoint_crosses_both_ways(direction, tmp_path):
    """A float32 checkpoint of the modulated chain taken mid-stream by one
    package continues in the other: the keys, knots and phases carry on,
    so the continuation's noise and dither equal the continuation of the
    package that took it, up to the float32 read's rounding (which may
    flip a dither step)."""
    x = stereo_signal(0.3, seed=17)
    half = 6144
    src, dst = (_jax32, _port) if direction == "dsp_tpu to the port" else (_port, _jax32)
    a = src(MODULATED, 2048)
    a.process_array(x[:half], drain=False)
    a.save_state(str(tmp_path / "ck.npz"))
    b = dst(MODULATED, 2048)
    b.load_state(str(tmp_path / "ck.npz"))
    y_a = np.asarray(a.process_array(x[half:], drain=False))
    y_b = np.asarray(b.process_array(x[half:], drain=False))
    assert y_a.shape == y_b.shape
    step = 2.0 ** -15
    n_diff = int((np.abs(y_a - y_b) > 1e-6).sum())
    print(f"checkpoint {direction}: {n_diff} differ by more than 1e-6, "
          f"worst {worst_dbfs(y_a, y_b):.1f} dBFS")
    assert np.abs(y_a - y_b).max() <= 2 * step
    assert n_diff <= CHECKPOINT_PIN
    # the streams carried on from the checkpoint: the same keys and phases
    for sa, sb in zip(a.states, b.states):
        if isinstance(sa, dict) and "key" in sa:
            np.testing.assert_array_equal(np.asarray(sa["key"]), np.asarray(sb["key"]))
            if "t" in sa:
                np.testing.assert_array_equal(np.asarray(sa["t"]), np.asarray(sb["t"]))


CHECKPOINT_PIN = 1800  # measured 1146 and 1240 of 14172, each one step of 16 bits
