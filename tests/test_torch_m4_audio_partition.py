"""A CPU model of how csrc/m4_audio.cu (K12 + K13) partitions matrix4's
audio path on the card, held against the plain version m4_audio_ref.

The kernel runs a block in tiles of `threads` x SEG samples: a tile's
signal s is run by `threads` threads, each folding its segment of SEG
samples into one affine map per recurrence (the dynamic shelf, the dynamic
lowpass, the allpass's o0 chain); a shuffle scan inside each warp of 32
segments gives the maps from the warp's start, the recurrence's value is
carried across the warps in order (and from tile to tile), and each
segment is rerun from its start value. The interpolated values take u
from a 32-entry table and the set from a shift. This model does the same
operations in the same grouping, in float64 torch ops (the card may fuse a
multiply and an add; the model does not), so:

* against m4_audio_ref it differs by rounding only, held at -280 dBFS,
  the kernel's own tolerance in chip_smoke.py;
* under another thread count with the same segments it gives the same
  bits: the scan's grouping, not the tiling, sets the rounding.

Inputs are seeded numpy: coefficient sets near matrix4's ranges (the
allpass coefficient inside (-1, 1)), the lookahead line and the states.
No jax: the plain version is the reference here.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from dsp_tpu_torch.ops import m4_engine as m4

SEG = 8  # a thread's samples in a tile (csrc/m4_audio.cu kSeg)
LIMIT = 10.0 ** (-280.0 / 20.0)
CONFIGS = ["matrix4 -6", "matrix4 direct_path -6", "matrix4 phase_flip=false -6",
           "matrix4 direct_path,phase_flip=false -6"]


def _audio_cfg(words):
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    return build_chain_from_string(words, StreamInfo(44100, 2)).effects[0].audio


def _inputs(cfg, B, seed):
    """x, the line, interp_c, ics and the three states, seeded."""
    rng = np.random.default_rng(seed)
    Nc = B // m4.DOWNSAMPLE_FACTOR
    base = np.concatenate([rng.uniform(-1, 1, 8), rng.uniform(0.2, 1.0, 4),
                           rng.uniform(-0.8, 0.8, 2), rng.uniform(0.3, 1.0, 2)])

    def sets(n):
        c0 = base + 0.05 * rng.standard_normal((n, 16))
        c0[:, 12:14] = np.clip(c0[:, 12:14], -0.85, 0.85)
        c1 = 0.02 * rng.standard_normal((n, 16))
        c2 = 0.01 * rng.standard_normal((n, 16))
        return np.stack([c0, c1, c2], axis=1)

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))  # noqa: E731
    x = t(rng.standard_normal((B, cfg.n_in)) * 0.3)
    buf = t(rng.standard_normal((cfg.len, 2)) * 0.3)
    return (x, buf, t(sets(1)[0]), t(sets(Nc)), t(rng.standard_normal(4) * 0.05),
            t(rng.standard_normal(4) * 0.05), t(rng.standard_normal((2, 2)) * 0.05))


def u_table():
    """The interpolation's u by (t+1) % D as the kernel tabulates it: the
    D values k/D, each from interp_vals_ref's division."""
    return torch.arange(m4.DOWNSAMPLE_FACTOR).to(torch.float64) / m4.DOWNSAMPLE_FACTOR


def _warp_scan(a, b):
    """The shuffle scan inside each warp of 32 segments, over the last axis
    [..., W, 32]: the inclusive maps (a, b), and the exclusive ones."""
    for d in (1, 2, 4, 8, 16):
        ao, bo = a[..., :-d], b[..., :-d]
        nb = torch.cat([b[..., :d], a[..., d:] * bo + b[..., d:]], dim=-1)
        na = torch.cat([a[..., :d], a[..., d:] * ao], dim=-1)
        a, b = na, nb
    ea = torch.cat([torch.ones_like(a[..., :1]), a[..., :-1]], dim=-1)
    eb = torch.cat([torch.zeros_like(b[..., :1]), b[..., :-1]], dim=-1)
    return (a, b), (ea, eb)


def _starts(fa, fb, carry):
    """Each segment's start value from the segment maps fa, fb [S, T] of
    one tile (T threads a signal) and the values carried in [S]: the warp
    scan, then the value carried across the warps in order. Returns (the
    starts [S, T], the carry out)."""
    S, T = fa.shape
    (ia, ib), (ea, eb) = _warp_scan(fa.reshape(S, T // 32, 32), fb.reshape(S, T // 32, 32))
    v, starts = carry, []
    for w in range(T // 32):
        starts.append(v)
        v = ia[:, w, -1] * v + ib[:, w, -1]
    vs = torch.stack(starts, dim=1)[..., None]  # [S, W, 1]
    return (ea * vs + eb).reshape(S, T), v


def m4_audio_model(cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m, threads=256):
    """m4_audio's results (y, shelf_m', lp_m', pf_m') computed in
    csrc/m4_audio.cu's partition with `threads` threads a signal, float64."""
    B = x.shape[0]
    tile = threads * SEG
    u_tab = u_table()
    sets = torch.cat([interp_c[None], ics])
    t_all = torch.arange(B)
    u_all = u_tab[(t_all + 1) & (m4.DOWNSAMPLE_FACTOR - 1)][:, None]
    coefs = sets[(t_all + 1) >> 5]
    vals = (coefs[:, 2] * u_all + coefs[:, 1]) * u_all + coefs[:, 0]  # [B, 16]
    delayed = torch.cat([buf, x[:, [cfg.c0, cfg.c1]]])[:B]
    s0, s1 = delayed[:, 0], delayed[:, 1]
    sig = torch.stack([s0 * vals[:, 2 * w] + s1 * vals[:, 2 * w + 1] + (1e-15 if w >= 2 else 0.0)
                       for w in range(4)])  # [4, B]
    carry = {"shelf": shelf_m.clone(), "lp": lp_m.clone(), "o0": pf_m[:, 1].clone(),
             "i0": pf_m[:, 0].clone()}
    filters = [(f, cfg.shelf, (10, 10, 8, 8)) for f in ("shelf",) if cfg.shelf_on]
    filters += [(f, cfg.lowpass, (11, 11, 9, 9)) for f in ("lp",) if cfg.lowpass_on]
    pf = sig[2:].clone()
    for t0 in range(0, B, tile):
        n = min(tile, B - t0)
        pad = tile - n

        def segs(v, fill):  # [S, n] -> [S, threads, SEG], empty samples filled
            return torch.cat([v, v.new_full((v.shape[0], pad), fill)], dim=1).reshape(
                v.shape[0], threads, SEG)

        valid = segs(torch.ones((1, n), dtype=torch.bool), False)[0]  # [threads, SEG]
        vt = vals[t0:t0 + n]
        for name, pr, ks in filters:
            g = torch.stack([vt[:, k] for k in ks])  # [4, n]
            sn = sig[:, t0:t0 + n] * pr["norm"]
            gcp1 = g * pr["cos_w0_p1"]
            c0s = (pr["sin_w0"] + gcp1) * sn
            b = (pr["sin_w0"] - gcp1) * sn - pr["c2"] * c0s
            a = -pr["c2"]
            c0s_s, b_s = segs(c0s, 0.0), segs(b, 0.0)
            fa = torch.ones((4, threads), dtype=torch.float64)
            fb = torch.zeros((4, threads), dtype=torch.float64)
            for i in range(SEG):
                on = valid[:, i]
                fb = torch.where(on, a * fb + b_s[..., i], fb)
                fa = torch.where(on, a * fa, fa)
            m, carry[name] = _starts(fa, fb, carry[name])
            out = []
            for i in range(SEG):
                out.append(c0s_s[..., i] + m)
                m = a * m + b_s[..., i]
            sig[:, t0:t0 + n] = torch.stack(out, dim=-1).reshape(4, tile)[:, :n]
        if cfg.phase_flip:
            xs = sig[2:, t0:t0 + n]
            c0 = vt[:, 12:14].T  # [2, n]
            prev = torch.cat([carry["i0"][:, None], xs[:, :-1]], dim=1)
            xs_s, c0_s, i0_s = segs(xs, 0.0), segs(c0, 0.0), segs(prev, 0.0)
            fa = torch.ones((2, threads), dtype=torch.float64)
            fb = torch.zeros((2, threads), dtype=torch.float64)
            for i in range(SEG):
                on = valid[:, i]
                c = c0_s[..., i]
                fb = torch.where(on, -c * fb + (i0_s[..., i] + c * xs_s[..., i]), fb)
                fa = torch.where(on, -c * fa, fa)
            o0, carry["o0"] = _starts(fa, fb, carry["o0"])
            out = []
            for i in range(SEG):
                r = i0_s[..., i] + c0_s[..., i] * (xs_s[..., i] - o0)
                out.append(r)
                o0 = r
            pf[:, t0:t0 + n] = torch.stack(out, dim=-1).reshape(2, tile)[:, :n]
            carry["i0"] = xs[:, -1].clone()
        else:
            pf[:, t0:t0 + n] = sig[2:, t0:t0 + n]
    cols = [sig[0] if k == cfg.c0 else sig[1] if k == cfg.c1 else x[:, k] for k in range(cfg.n_in)]
    if cfg.direct_path:
        amb, dire = vals[:, 14], vals[:, 15]
        cols += [(pf[0] - 1e-15) * amb, (pf[1] - 1e-15) * amb,
                 (sig[2] - 1e-15) * dire, -(sig[3] - 1e-15) * dire]
    else:
        cols += [pf[0] - 1e-15, pf[1] - 1e-15]
    pf_out = (torch.stack([carry["i0"], carry["o0"]], dim=1) if cfg.phase_flip else pf_m)
    return (torch.stack(cols, dim=1), carry["shelf"] if cfg.shelf_on else shelf_m,
            carry["lp"] if cfg.lowpass_on else lp_m, pf_out)


def test_u_table_is_the_division():
    """The 32-entry table of u the kernel reads, indexed by (t+1) % 32,
    equals interp_vals_ref's ((t+1) % D)/D for every t, bit for bit; and
    the values it gives with the set taken by a shift equal
    interp_vals_ref's."""
    D = m4.DOWNSAMPLE_FACTOR
    assert D == 32
    u = u_table()
    t = torch.arange(65536)
    want = ((t + 1) % D).to(torch.float64) / D
    assert torch.equal(u[(t + 1) & 31], want)
    assert torch.equal(u, torch.tensor([k / 32 for k in range(32)], dtype=torch.float64))
    cfg = _audio_cfg("matrix4 -6")
    _, _, ic, ics, _, _, _ = _inputs(cfg, 2048, 1)
    sets = torch.cat([ic[None], ics])
    tt = torch.arange(2048)
    coefs = sets[(tt + 1) >> 5]
    uu = u[(tt + 1) & 31][:, None]
    assert torch.equal((coefs[:, 2] * uu + coefs[:, 1]) * uu + coefs[:, 0],
                       m4.interp_vals_ref(ic, ics, 2048))


@pytest.mark.parametrize("B", [2048, 5120], ids=["B=2048", "B=5120 (2.5 tiles)"])
@pytest.mark.parametrize("words", CONFIGS)
def test_model_matches_plain_version(words, B):
    """The partition against m4_audio_ref within -280 dBFS (y and the
    states), at one tile and at two and a half."""
    cfg = _audio_cfg(words)
    ins = _inputs(cfg, B, B + len(words))
    got = m4_audio_model(cfg, *ins)
    want = m4.m4_audio_ref(cfg, *ins)
    assert got[0].shape == want[0].shape
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= LIMIT


@pytest.mark.parametrize("threads", [64, 512, 1024])
@pytest.mark.parametrize("words", CONFIGS[:2])
def test_model_bits_do_not_depend_on_the_thread_count(words, threads):
    """Under another thread count a signal (so other tiles: 512, 4096 and
    8192 samples) with the same segments the model gives the same bits as
    under 256 threads (tiles of 2048), over a block of 5120."""
    cfg = _audio_cfg(words)
    ins = _inputs(cfg, 5120, 77)
    base = m4_audio_model(cfg, *ins, threads=256)
    other = m4_audio_model(cfg, *ins, threads=threads)
    for a, b in zip(base, other):
        assert torch.equal(a, b)
