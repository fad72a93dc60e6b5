"""The modulated delay's rounding (K14's plain version) against dsp_tpu
float64, as dsp_tpu's chain runs the effect: its step inside a jitted
lax.scan over blocks.

In that scan XLA:CPU rounds the modulator's phase t0 + step·n twice (the
product step·n does not depend on the carried state, and leaves the loop),
and fuses six products into their sums: each knot's six terms (one FMA a
term, in order from 0), the B-spline's c0 = fma(2/3, z1, a/6) and two of
its Horner steps, and the Hermite read's first term and two Horner steps.
mod_delay_ref writes the same operations in the same order (measured on
this package's CPU: every output of the Hermite read bit for bit). Only
the polyphase filters' tap sums stay apart: XLA:CPU reduces each filter's
taps in an order of its own, and the port sums them from tap 0, one FMA a
tap, in its plain version and its kernel alike.

Each case is held within 10 dB of its measurement, the Hermite read
bit for bit. Before the repair the same chains sat -265 to -271 dBFS
from dsp_tpu (knots summed by torch.sum, the B-splines and the Hermite read
rounded at every operation).
"""

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import FS, jax_chain, port_chain, stereo_signal, worst_dbfs

# (chain, the worst measured dBFS at blocks 2048 and 300, the pin), each at
# block 2048 and the first also at 300: the
# pins sit within 10 dB of the worst block's measurement
CHAINS = [
    ("delay -m 2m -q 1 -b 300 10m", -307.1, -300.0),
    ("delay -m 2m -q 2 -b 300 10m", -307.1, -300.0),
    ("delay -M 2m -q 1 -b 300 10m", -307.1, -300.0),
]


def _both(spec, block, x, seed=4321):
    np.random.seed(seed)
    t = port_chain(spec, block)
    np.random.seed(seed)
    j = jax_chain(spec, block)
    return t.process_array(x), np.asarray(j.process_array(x))


@pytest.mark.parametrize("spec,measured,pin,block",
                         [(*c, 2048) for c in CHAINS] + [(*CHAINS[0], 300)],
                         ids=[f"{c[0]} -b 2048" for c in CHAINS] + [f"{CHAINS[0][0]} -b 300"])
def test_modulated_chain_near_dsp_tpu(spec, measured, pin, block):
    assert pin <= measured + 10.0
    x = stereo_signal(0.3, seed=2)
    y_t, y_j = _both(spec, block, x)
    assert y_t.shape == y_j.shape
    assert worst_dbfs(y_t, y_j) <= pin


@pytest.mark.parametrize("block", [2048, 64])
def test_hermite_read_equals_dsp_tpu(block):
    """q0 (the Hermite read) has no tap sum: the chain's output equals
    dsp_tpu's bit for bit."""
    x = stereo_signal(0.3, seed=2)
    y_t, y_j = _both("delay -m 2m -q 0 -b 300 10m", block, x)
    np.testing.assert_array_equal(y_t, y_j)


# (quality, -M, modulator Hz, the worst block's measured dBFS, the pin).
# -M's polyphase cases sit apart: when the effect runs alone in the scan,
# XLA:CPU also fuses its fraction z·depth - d_int into one FMA, and when an
# integer delay runs before it (the chains above, and every chain that
# gives -M a delay) it does not; the port follows the chain.
EFFECT_CASES = [
    (2, False, 1.0, -307.1, -300.0),
    (2, False, 1000.0, -309.5, -300.0),
    (2, False, 5000.0, -307.1, -300.0),
    (1, True, 1000.0, -275.9, -270.0),
    (2, True, 5000.0, -278.7, -270.0),
    (0, False, 5000.0, None, None),
]


@pytest.mark.parametrize("qual,mono,fc,measured,pin", EFFECT_CASES,
                         ids=[f"q{c[0]}{'M' if c[1] else 'm'}-{c[2]:g}Hz" for c in EFFECT_CASES])
def test_effect_step_over_blocks_near_dsp_tpu(qual, mono, fc, measured, pin):
    """ModDelayEffect.step from a carried state (a phase, knots and a line
    that are not zero), block by block, against dsp_tpu's step in a jitted
    lax.scan over the same blocks: the outputs within the pin (q0 bit for
    bit), the knot window and phase bit for bit."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.delay import ModDelayEffect as JMod
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.delay import ModDelayEffect

    if pin is not None:
        assert pin <= measured + 10.0
    args = ("delay", None, np.ones(2, dtype=bool), 2e-3 * FS, fc, mono, qual, 777)
    t = ModDelayEffect(args[0], StreamInfo(FS, 2), *args[2:])
    j = JMod(args[0], JStream(FS, 2), *args[2:])
    rng = np.random.default_rng(int(fc) + qual)
    st = {k: np.asarray(v) for k, v in t.state0().items()}
    st["buf"] = rng.standard_normal(st["buf"].shape) * 0.3
    st["y"] = rng.standard_normal(st["y"].shape) * 0.1
    st["t"] = np.float64(0.6180339887)
    xs = rng.standard_normal((3, 2048, 2)) * 0.3
    _, ys = jax.jit(lambda s, x: jax.lax.scan(j.step, s, x))(
        {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(xs))
    st_t = {k: torch.as_tensor(v) for k, v in st.items()}
    st_j = {k: jnp.asarray(v) for k, v in st.items()}
    step_j = jax.jit(j.step)
    for b in range(xs.shape[0]):
        st_t, y_t = t.step(st_t, torch.as_tensor(xs[b]))
        st_j, _ = step_j(st_j, jnp.asarray(xs[b]))  # the carried state alone
        if pin is None:
            np.testing.assert_array_equal(y_t.numpy(), np.asarray(ys[b]))
        else:
            assert worst_dbfs(y_t.numpy(), np.asarray(ys[b])) <= pin
        for k in ("y", "t", "buf", "key"):
            np.testing.assert_array_equal(st_t[k].numpy(), np.asarray(st_j[k]))
