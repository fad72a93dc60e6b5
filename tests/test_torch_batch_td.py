"""Batched processing of the time-domain effects (modulated delay, noise,
dither, stats, levels) on the CPU: CompiledChain.process_batch and the
stream axis of the five wrappers of ops/time_domain.py (the batch against
dsp_tpu's is tests/test_torch_batch_td_jax.py).

* each wrapper in float64 and float32 at S = 3 streams, each stream's state
  from a one-stream run of its own seed and length (keys, error histories,
  noise carries, sums, meters, phases, knot windows and lines all differ;
  stats' samples too, and one stream's limit falls inside the block): each
  stream of the S-stream call bit-equal to a one-stream call, since the
  plain versions run a stream at a time. A wrapper that read stream 0's
  state for every stream would fail here, and nowhere in a batch, whose
  streams all start from one live state;
* process_batch of the s16 delivery chain (its dither enabled at 16 bits,
  as the CLI's s16 writer enables it) and the modulated chain, both
  dtypes, each stream bit-equal to process_array of that stream from the
  same live state;
* the streams' states: cc._step over CompiledChain._stream_states, each
  stream's final state of every effect (stats with a limit inside a block,
  levels, dither, the delays) bit-equal to a one-stream run's; every leaf
  of the five takes the stream axis (the keys [S, 2], stats' samples and
  limit and the delay's phase [S]).

About 25 s serial.
"""

import numpy as np
import pytest
import torch

from torch_parity import FS, stereo_signal

S = 3
B = 256  # the forms' block
SEED = 20263
DELIVERY = "gain -1 :1 delay -f 0.37m : dither lipshitz stats -i"
MODULATED = "delay -M 0.5m -q 2 10m noise -90 dither sloped2 16 stats levels"
CHAINS = {"delivery": DELIVERY, "modulated": MODULATED}
DTYPES = {"f64": torch.float64, "f32": torch.float32}
SECONDS = 0.2


def chain(spec, block, dtype):
    """The port's chain on the CPU, numpy's generator seeded before it is
    built (the effects draw their keys from it), the dither's auto bits set
    to 16 as for s16 output."""
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.chain.chain import chain_set_dither_params
    from dsp_tpu_torch.core.types import StreamInfo

    np.random.seed(SEED)
    c = build_chain_from_string(spec, StreamInfo(FS, 2))
    chain_set_dither_params(c, 16, True)
    return CompiledChain(c, block, dtype=dtype, device="cpu")


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def pick(tree, s):
    """Stream s of a tree of stream-axis tensors."""
    if isinstance(tree, dict):
        return {k: pick(v, s) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(pick(v, s) for v in tree)
    return tree[s] if isinstance(tree, torch.Tensor) else tree


def stack(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: stack([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack([it[i] for it in items]) for i in range(len(first)))
    return torch.stack(items)


def leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def assert_bits_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for u, v in zip(la, lb):
        assert u.dtype == v.dtype and u.shape == v.shape
        if u.is_floating_point():
            assert torch.equal(u.view(torch.int64 if u.dtype == torch.float64 else torch.int32),
                               v.view(torch.int64 if v.dtype == torch.float64 else torch.int32))
        else:
            assert torch.equal(u, v)


def streams(n, seed):
    """S streams of n frames, each its own seed."""
    return np.stack([stereo_signal(n / FS + 0.01, seed=seed + s)[:n] for s in range(S)])


def block(dt, s, k, scale=0.3, n=B):
    """A one-stream block of n frames, stream s's k-th, its own seed."""
    return torch.as_tensor(np.random.default_rng(1000 * s + k).standard_normal((n, 2)) * scale,
                           dtype=dt)


def warmed(step, state0, dt, n=B):
    """S one-stream states: stream s from state0(s) after 1 + s blocks of
    n frames of its own input through step(state, x) -> state."""
    out = []
    for s in range(S):
        st = state0(s)
        for k in range(1 + s):
            st = step(st, block(dt, s, k, n=n))
        out.append(st)
    return out


def check_streams(call, states, x):
    """call(state, x) at S streams against a one-stream call a stream; the
    streams' states must differ."""
    got = call(stack(states), x)
    for s in range(S):
        assert_bits_equal(pick(got, s), call(states[s], x[s]))
    return got


# --- the five wrappers: S streams in one call --------------------------------


@pytest.mark.parametrize("dt", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("every", [True, False], ids=["every channel", "the first channel"])
def test_noise_streams(dt, every):
    from dsp_tpu_torch.core.prng import prng_key
    from dsp_tpu_torch.ops import time_domain as td

    mult = 1e-3 / 0x7FFFFFFF
    sel = None if every else torch.tensor([True, False])
    keys = warmed(lambda k, x: td.tpdf_noise(k, x, mult, sel)[0],
                  lambda s: prng_key(500 + s), dt)
    assert len({tuple(k.tolist()) for k in keys}) == S
    x = torch.stack([block(dt, s, 9) for s in range(S)])
    check_streams(lambda k, x_: td.tpdf_noise(k, x_, mult, sel), keys, x)


@pytest.mark.parametrize("dt", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("shape", ["flat", "lipshitz", "sloped2"])
def test_dither_streams(dt, shape):
    from dsp_tpu_torch.core.prng import prng_key
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.dither import DitherEffect
    from dsp_tpu_torch.ops import time_domain as td

    e = DitherEffect("dither", StreamInfo(FS, 2), np.ones(2, dtype=bool), shape, 16.0, 16, False,
                     False, seed=1)
    consts = [torch.as_tensor(v, dtype=None if v.dtype == bool else dt)
              for v in (e.n_mult, e.q_mult0, e.q_mult1, e.enabled, e.fir)]

    def call(st, x):
        out = td.tpdf_dither(st[0], x, st[1], st[2], *consts, e.mode)
        return out[:3], out[3]

    def state0(s):
        rng = np.random.default_rng(s)
        return (prng_key(700 + s), torch.as_tensor(rng.standard_normal((9, 2)) * 1e-5, dtype=dt),
                torch.as_tensor(rng.uniform(0, 0x7FFFFFFF, 2), dtype=dt))

    states = warmed(lambda st, x: call(st, x)[0], state0, dt)
    x = torch.stack([block(dt, s, 9) for s in range(S)])
    got = check_streams(call, states, x)
    assert not torch.equal(got[1][0], got[1][1])


@pytest.mark.parametrize("dt", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("interp", [False, True], ids=["plain", "-i"])
def test_stats_streams(dt, interp):
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.stats import StatsEffect
    from dsp_tpu_torch.ops import time_domain as td

    e = StatsEffect("stats", StreamInfo(FS, 2), np.ones(2, dtype=bool), None, 80, interp)
    table = torch.as_tensor(e._insert_table, dtype=dt) if interp else None

    def state0(s):
        st = {k: torch.as_tensor(v) for k, v in e.state0().items()}
        return {k: v.to(dt) if v.is_floating_point() else v for k, v in st.items()}

    def quantized(x):
        return torch.round(x * 32768) / 32768

    states = warmed(lambda st, x: td.stats_step(st, quantized(x), table), state0, dt)
    states[1]["limit"] = states[1]["samples"] + 100  # inside the next block
    assert len({int(st["samples"]) for st in states}) == S
    x = quantized(torch.stack([block(dt, s, 9, scale=0.3 + 0.2 * s) for s in range(S)]))
    got = check_streams(lambda st, x_: td.stats_step(st, x_, table), states, x)
    assert got["samples"].tolist() == [2 * B, int(states[1]["limit"]), 4 * B]
    assert len({tuple(v.tolist()) for v in got["sum"]}) == S


@pytest.mark.parametrize("dt", DTYPES.values(), ids=DTYPES.keys())
def test_levels_streams(dt):
    from dsp_tpu_torch.ops import time_domain as td

    g = 1.0 - np.exp(-1.0 / (FS * 0.3))

    def state0(s):
        rng = np.random.default_rng(30 + s)
        return tuple(torch.as_tensor(rng.uniform(0, 0.1, 2), dtype=dt) for _ in range(3))

    states = warmed(lambda st, x: td.levels_step(*st, x, g), state0, dt)
    x = torch.stack([block(dt, s, 9) for s in range(S)])
    check_streams(lambda st, x_: td.levels_step(*st, x_, g), states, x)


@pytest.mark.parametrize("dt", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("qual", [0, 2])
@pytest.mark.parametrize("mono", [False, True], ids=["-m", "-M"])
def test_mod_delay_streams(dt, qual, mono):
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.delay import ModDelayEffect
    from dsp_tpu_torch.ops import time_domain as td

    e = ModDelayEffect("delay", StreamInfo(FS, 2), np.ones(2, dtype=bool), 0.5e-3 * FS, 1000.0,
                       mono, qual, seed=1)
    table = None if e.table is None else torch.as_tensor(e.table, dtype=dt)
    sel = torch.ones(2, dtype=torch.bool)

    def call(st, x):
        key, yk, t, y, buf = td.mod_delay(*st, x, sel, table, e.depth, e.step_size, e.n_taps,
                                          qual)
        return (key, yk, t, buf), y

    def state0(s):
        e.seed = 40 + s
        st = e.state0()
        return tuple(torch.as_tensor(st[k], dtype=dt if st[k].dtype.kind == "f" else None)
                     for k in ("key", "y", "t", "buf"))

    # blocks of 128: the polyphase read is the plain versions' slowest
    states = warmed(lambda st, x: call(st, x)[0], state0, dt, n=128)
    assert len({float(st[2]) for st in states}) == S  # the phases
    x = torch.stack([block(dt, s, 9, n=128) for s in range(S)])
    check_streams(call, states, x)


# --- the chains: process_batch and the streams' states ----------------------


@pytest.fixture(scope="module")
def batch_input():
    return streams(int(SECONDS * FS), seed=50)


@pytest.mark.parametrize("dt", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("name", CHAINS)
def test_batch_matches_process_array_per_stream(name, dt, batch_input):
    """Every stream of process_batch is process_array of that stream from
    the same live state: the same key for every stream, stats counting to
    the live limit."""
    cc = chain(CHAINS[name], 2048, dt)
    live = clone(cc.states)
    batch = cc.process_batch(batch_input)
    for a, b in zip(leaves(live), leaves(cc.states)):
        assert torch.equal(a, b)  # the live state neither consumed nor advanced
    for s in range(S):
        cc.states = clone(live)
        np.testing.assert_array_equal(batch[s], cc.process_array(batch_input[s]))
    if name == "delivery":  # on the 16-bit grid: the dither ran
        assert np.array_equal(batch, np.round(batch * 32768) / 32768)


@pytest.mark.parametrize("dt", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("name", CHAINS)
def test_stream_states_match_one_stream_runs(name, dt):
    """cc._step over _stream_states, block by block: each stream's final
    state of every effect equals a one-stream run's from the live state,
    stats counting to a limit inside the last block."""
    Bc, nb = 1024, 4
    cc = chain(CHAINS[name], Bc, dt)
    cc.set_valid_frames(nb * Bc - 300)
    live = clone(cc.states)
    xs = cc._input(streams(nb * Bc, seed=60))
    states = cc._stream_states(cc.states, S)
    for b in range(nb):
        states, _ = cc._step(states, xs[:, b * Bc:(b + 1) * Bc].contiguous())
    for s in range(S):
        one = clone(live)
        for b in range(nb):
            one, _ = cc._step(one, xs[s, b * Bc:(b + 1) * Bc].contiguous())
        assert_bits_equal(pick(states, s), one)
    kinds = {e.name for e in cc._runtime_effects}
    assert {"stats", "dither", "delay"} <= kinds
    stats = next(st for e, st in zip(cc._runtime_effects, states) if e.name == "stats")
    assert stats["samples"].tolist() == [nb * Bc - 300] * S


def test_stream_states_give_every_leaf_the_axis():
    cc = chain(MODULATED + " stats -i", 2048, torch.float64)
    assert sum(e.name == "stats" for e in cc._runtime_effects) == 2
    for e, live, st in zip(cc._runtime_effects, cc.states, cc._stream_states(cc.states, S)):
        for a, b in zip(leaves(live), leaves(st)):
            assert b.shape == (S, *a.shape), (e.name, a.shape, b.shape)
            for s in range(S):
                assert torch.equal(b[s], a)
