"""Slice F of dsp_tpu_torch against dsp_tpu, on the CPU in float64: the
`matrix4_mb` chain's state, hooks and display (its CLI runs:
test_torch_matrix4_mb_cli.py; the bench golden's control replayed:
test_torch_matrix4_mb_golden.py, files of their own so that the parallel
runner can place them on other workers). Each limit is pinned ~30 dB above its
measurement unless named; the stream's first tenths of a second carry the
engine's chaotic start (test_torch_matrix4_mb_chain.py).
"""

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from test_torch_matrix4 import transient_signal
from test_torch_matrix4_mb import _effects, _tensors
from torch_parity import jax_chain, port_chain, worst_dbfs


# --- state and display ---------------------------------------------------------------


@pytest.mark.parametrize("first", ["dsp_tpu", "dsp_tpu_torch"])
def test_checkpoint_crosses_packages(first, tmp_path):
    """A matrix4_mb chain (the fir, the effect) saved mid-stream with events
    in flight in one package continues in the other: the leaves keep their
    dtypes, and the continuation matches the first package's own (the
    packages' free runs differ at the stream's start, where the engine is
    chaotic: test_torch_matrix4_mb_chain.py)."""
    from dsp_tpu_torch.convert import flatten_states

    spec, block = "matrix4_mb -6", 2048
    x = transient_signal(0.93, seed=11)[: 20 * block].reshape(2, 10, block, 2)
    make = {"dsp_tpu": jax_chain, "dsp_tpu_torch": port_chain}
    a = make[first](spec, block)
    a.run_blocks(x[0])
    a.save_state(str(tmp_path / "s.npz"))
    want = np.asarray(a.run_blocks(x[1]))
    b = make["dsp_tpu_torch" if first == "dsp_tpu" else "dsp_tpu"](spec, block)
    b.load_state(str(tmp_path / "s.npz"))
    if first == "dsp_tpu":
        leaves, _ = flatten_states(b.states)
        with np.load(tmp_path / "s.npz") as z:
            for i, leaf in enumerate(leaves):
                assert str(leaf.dtype).removeprefix("torch.") == str(z[f"leaf_{i}"].dtype)
                assert np.array_equal(leaf.numpy(), z[f"leaf_{i}"])
        st = next(s for s in b.states if isinstance(s, dict) and "ev_thresh" in s)
        assert st["fade_p"].device.type == "cpu" and st["ev"]["hold"].dtype == torch.bool
        assert int(st["ev"]["diff_count"].sum()) > 0
    got = np.asarray(b.run_blocks(x[1]))
    assert got.shape == want.shape == (10, block, 4)
    print(f"checkpoint from {first}: {worst_dbfs(got, want):.1f} dBFS")
    assert worst_dbfs(got, want) <= -215.0


def test_legacy_bank_checkpoint_is_refused(tmp_path):
    """dsp_tpu's state0 carries the sequential bank (a dict a cap); the port
    runs only the fused bank and refuses such a checkpoint by name."""
    import jax

    from dsp_tpu_torch.chain.chain import ChainError

    j = jax_chain("matrix4_mb -6", 2048)
    mb = next(e for e in j.chain.effects if type(e).__name__ == "Matrix4MbEffect")
    states = [mb.state0() if isinstance(s, dict) and "ev_thresh" in s else s for s in j.states]
    leaves, treedef = jax.tree_util.tree_flatten(states)
    arrays = {f"leaf_{i}": np.asarray(a) for i, a in enumerate(leaves)}
    np.savez(tmp_path / "legacy.npz", __treedef__=np.asarray(str(treedef)),
             __effects__=np.asarray("|".join(e.name for e in j._runtime_effects)), **arrays)
    t = port_chain("matrix4_mb -6", 2048)
    with pytest.raises(ChainError, match="sequential filter-bank state"):
        t.load_state(str(tmp_path / "legacy.npz"))


def test_status_lines_and_signal_equal_dsp_tpu(monkeypatch):
    """The 13 status lines (text and bars, on and off) read from aux as
    dsp_tpu writes them; `signal` toggles on the host with no device read."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    for kind in ("text", "bars"):
        e, je = _effects([f"status={kind},signal"])
        for disabled in (False, True):
            aux = rng.uniform(-0.8, 0.8, (64, 13, 2))
            st = _tensors(e.state_for_block(2048))
            st["aux"], st["disable"] = torch.as_tensor(aux), torch.tensor(disabled)
            jst = dict(je.state_for_block(2048), aux=aux, disable=np.bool_(disabled))
            e.host_update(st)
            je.host_update(jst)
            assert [sl.text for sl in e._statuslines] == [sl.text for sl in je._statuslines]
            e.host_finish(st)
            je.host_finish(jst)
    e, je = _effects(["signal"])
    st = _tensors(e.state_for_block(2048))
    st["fade_p"] = torch.tensor(3000, dtype=torch.int64)
    jst = {"fade_p": jnp.asarray(3000, jnp.int64), "disable": jnp.asarray(False)}
    monkeypatch.setattr(torch.Tensor, "cuda", lambda *a, **k: pytest.fail("device copy"))
    for _ in range(3):
        e.signal()
        je.signal()
        e.host_update(st)
        je.host_update(jst)
        assert st["fade_p"].device.type == "cpu"
        assert int(st["fade_p"]) == int(jst["fade_p"]) and bool(st["disable"]) == bool(jst["disable"])


def test_chain_hooks_equal_dsp_tpu():
    """Channel dependencies, latencies and drain of `matrix4_mb` in the
    chain: the fir before the effect, the latency of the lookahead and the
    FIR's group delay on every output, the surround delay asked for."""
    from dsp_tpu.chain.chain import expected_out_frames as jexp
    from dsp_tpu_torch.chain.chain import expected_out_frames

    for spec, channels in (("matrix4_mb -6", 2), ("matrix4_mb direct_path -6", 2),
                           (":0,2 matrix4_mb surround_delay=20m -6", 3)):
        t, j = port_chain(spec, 2048, channels), jax_chain(spec, 2048, channels)
        assert [type(a).__name__ for a in t.chain.effects] == [type(a).__name__ for a in j.chain.effects]
        assert t.chain.drain_frames == j.chain.drain_frames
        assert t.chain.output_discard == j.chain.output_discard
        assert t.chain.ostream.channels == j.chain.ostream.channels
        for n in (1000, 44100):
            assert expected_out_frames(t.chain, n) == jexp(j.chain, n)
        for a, b in zip(t.chain.effects, j.chain.effects):
            if type(a).__name__ == "Matrix4MbEffect":
                assert np.array_equal(a.channel_deps(), b.channel_deps())
                for u, v in zip(a.channel_offsets(), b.channel_offsets()):
                    assert np.array_equal(u, v)
