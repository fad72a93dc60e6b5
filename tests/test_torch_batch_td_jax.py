"""Batched processing of the time-domain effects against dsp_tpu, on the
CPU in float64 (the port's batch against its own process_array is
tests/test_torch_batch_td.py):

* process_batch of the s16 delivery chain (its dither at 16 bits, as the
  CLI's s16 writer sets it) and the modulated chain on S = 3 streams
  against dsp_tpu's process_batch, which tiles the live state over the
  streams (every stream the same key) and vmaps its step: both with every
  quantized step equal. The modulated chain ends in a 16-bit dither, so
  the CHAIN_LIMIT_DBFS that test_torch_time_domain.py holds it to means
  equal here (measured: equal); the delivery chain as that file holds its
  s16 bytes;
* noise and dither chains the same way, equal, as that file holds them.
  Noise on every channel is the one exception, by one rounding: dsp_tpu's
  XLA:CPU takes x + (u1 - u2)·mult as one FMA when every channel is
  selected (its all-true select folded away), as the port does, but not
  under vmap, where it rounds the product first: dsp_tpu's own batch of
  `noise -60` differs from its own process_array of each stream in 0.3%
  of the samples (measured on the CPU). The port keeps one rounding for
  its batch and its process_array, so that a batch's stream is its
  process_array bit for bit; its selected-channel form, which rounds the
  product, equals dsp_tpu's batch bit for bit, and its FMA sits within
  the product's rounding of it;
* the noise and dither steps on 3 streams of distinct keys, error
  histories and noise carries against jax.vmap of dsp_tpu's own steps
  over them: every key, output, carry equal (the error histories within
  1e-15, as that file holds them; noise on every channel as above): stream
  s draws from key[s].

About 20 s serial.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import CHAIN_LIMIT_DBFS, FS, stereo_signal, worst_dbfs

S = 3
SEED = 20263
SECONDS = 0.25
DELIVERY = "gain -1 :1 delay -f 0.37m : dither lipshitz stats -i"
MODULATED = "delay -M 0.5m -q 2 10m noise -90 dither sloped2 16 stats levels"
DRAWN = [":0 noise 8b", "dither flat 12", "dither lipshitz 12", "dither sloped2 12"]
EVERY = "noise -60"  # every channel: one rounding from dsp_tpu's vmapped step


def chains(spec, block=2048):
    """(the port's, dsp_tpu's) chain, numpy's generator seeded alike before
    each is built, the dither's auto bits at 16 as for s16 output."""
    from dsp_tpu.chain import CompiledChain as JChain
    from dsp_tpu.chain import build_chain_from_string as jbuild
    from dsp_tpu.chain.chain import chain_set_dither_params as jset
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.chain.chain import chain_set_dither_params
    from dsp_tpu_torch.core.types import StreamInfo

    np.random.seed(SEED)
    t = build_chain_from_string(spec, StreamInfo(FS, 2))
    chain_set_dither_params(t, 16, True)
    t = CompiledChain(t, block, device="cpu")
    np.random.seed(SEED)
    j = jbuild(spec, JStream(FS, 2))
    jset(j, 16, True)
    return t, JChain(j, block)


@pytest.fixture(scope="module")
def xs():
    n = int(SECONDS * FS)
    return np.stack([stereo_signal(SECONDS + 0.01, seed=80 + s)[:n] for s in range(S)])


@pytest.fixture(scope="module")
def batches(xs):
    """{spec: (the port's batch, dsp_tpu's batch)} of the delivery,
    modulated and DRAWN chains, each rendered once."""
    out = {}
    for spec in (DELIVERY, MODULATED, EVERY, *DRAWN):
        t, j = chains(spec)
        out[spec] = t.process_batch(xs), np.asarray(j.process_batch(xs))
    return out


def test_modulated_batch_matches_dsp_tpu(batches):
    y_t, y_j = batches[MODULATED]
    assert y_t.shape == y_j.shape
    assert worst_dbfs(y_t, y_j) <= CHAIN_LIMIT_DBFS
    np.testing.assert_array_equal(y_t * 32768, y_j * 32768)
    assert not np.array_equal(y_t[0], y_t[1])


def test_delivery_batch_matches_dsp_tpu_step_for_step(batches):
    y_t, y_j = batches[DELIVERY]
    assert y_t.shape == y_j.shape
    steps_t, steps_j = y_t * 32768, y_j * 32768
    assert np.array_equal(steps_t, np.round(steps_t))  # on the 16-bit grid
    np.testing.assert_array_equal(steps_t, steps_j)


@pytest.mark.parametrize("spec", DRAWN)
def test_noise_and_dither_batches_equal_dsp_tpu(spec, batches):
    y_t, y_j = batches[spec]
    assert y_t.shape == y_j.shape
    np.testing.assert_array_equal(y_t, y_j)


def _within_the_products_rounding(y_fused, y_j, level):
    """y_fused (x + d·mult in one rounding) against y_j (d·mult rounded,
    then the sum): at most half an ulp of the product (|d·mult| <= level)
    and half an ulp of the sum apart."""
    assert np.all(np.abs(y_fused - y_j) <= np.spacing(level) + np.spacing(np.abs(y_j)))


def test_noise_batch_on_every_channel_matches_dsp_tpu(xs, batches):
    t, _ = chains(EVERY)
    noise = next(e for e in t.chain.effects if e.name == "noise")
    y_fused, y_j = batches[EVERY]
    noise._every = False  # its selected-channel form: x + where(sel, d·mult, 0)
    y_sel = t.process_batch(xs)
    np.testing.assert_array_equal(y_sel, y_j)
    _within_the_products_rounding(y_fused, y_j, 2e-3)
    assert not np.array_equal(y_fused, y_j)
    assert not np.array_equal(y_fused[0], y_fused[1])


def _keys(seed):
    from dsp_tpu_torch.core.prng import prng_key

    return np.stack([prng_key(seed + 7 * s).numpy() for s in range(S)])


@pytest.mark.parametrize("every", [True, False], ids=["every channel", "the second channel"])
def test_noise_streams_match_vmapped_dsp_tpu(every):
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.noise import NoiseEffect as JNoise
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.noise import NoiseEffect
    from dsp_tpu_torch.ops import time_domain

    sel = np.array([True, True]) if every else np.array([False, True])
    t = NoiseEffect("noise", StreamInfo(FS, 2), sel, 3e-4, seed=1)
    j = JNoise("noise", JStream(FS, 2), sel, 3e-4, seed=1)
    keys = _keys(900)
    x = np.random.default_rng(5).standard_normal((S, 1000, 2))
    k_t, y_t = t.step(torch.as_tensor(keys), torch.as_tensor(x))
    k_j, y_j = jax.vmap(j.step)(jnp.asarray(keys), jnp.asarray(x))
    y_j = np.asarray(y_j)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    assert len({tuple(k) for k in k_t.tolist()}) == S
    if every:
        # each key's draws: the product rounded first, as vmap rounds it
        _, y_sel = time_domain.tpdf_noise(torch.as_tensor(keys), torch.as_tensor(x), 3e-4,
                                          torch.ones(2, dtype=torch.bool))
        np.testing.assert_array_equal(y_sel.numpy(), y_j)
        _within_the_products_rounding(y_t.numpy(), y_j, 3e-4 * 2 ** 31)
    else:
        np.testing.assert_array_equal(y_t.numpy(), y_j)


@pytest.mark.parametrize("shape", ["flat", "sloped2", "lipshitz", "wan9"])
def test_dither_streams_match_vmapped_dsp_tpu(shape):
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.dither import DitherEffect as JDither
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.dither import DitherEffect

    fs = 48000 if shape.startswith("wan") else FS
    args = (np.ones(2, dtype=bool), shape, 12.0, 12, False, False)
    t = DitherEffect("dither", StreamInfo(fs, 2), *args, seed=1)
    j = JDither("dither", JStream(fs, 2), *args, seed=1)
    rng = np.random.default_rng(6)
    st = {"key": _keys(800), "ehist": rng.standard_normal((S, 9, 2)) * 1e-4,
          "nprev": rng.uniform(0, 0x7FFFFFFF, (S, 2))}
    x = rng.standard_normal((S, 700, 2)) * 0.4
    st_t, y_t = t.step({k: torch.as_tensor(v) for k, v in st.items()}, torch.as_tensor(x))
    st_j, y_j = jax.vmap(j.step)({k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(x))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(st_t["key"].numpy(), np.asarray(st_j["key"]))
    np.testing.assert_array_equal(st_t["nprev"].numpy(), np.asarray(st_j["nprev"]))
    np.testing.assert_allclose(st_t["ehist"].numpy(), np.asarray(st_j["ehist"]), rtol=0,
                               atol=1e-15)
    assert not np.array_equal(y_t[0].numpy(), y_t[1].numpy())
