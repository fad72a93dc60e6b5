"""A CPU model of how csrc/m4mb_audio.cu (matrix4_mb's K12 + K13)
partitions the audio path on the card, held against the plain version
m4mb_audio_ref.

The kernel runs a block in tiles of 256 samples of all 26 surround lanes:
a warp a lane, a thread a segment of 8 samples, which it folds into one
affine map of the allpass's o0; a shuffle scan inside the warp of 32
segments gives each segment its map from the tile's start, and the warp's
total is the tile's map of the lane. Each tile publishes its 26 maps, and
the look-back applies every earlier tile's maps to the carried o0, one
after another in tile order, from the block's start value; each segment is
then rerun from its start value. A block of B % 256 samples ends on a
partial tile whose empty segments are identity maps. This model does the
same operations in the same grouping, in float64 torch ops (the card takes
an FMA where it is written; the model does not), so:

* against m4mb_audio_ref it differs by rounding only, held at -290 dBFS,
  the kernel's own tolerance in chip_smoke.py (MB_AUDIO_DBFS);
* under another tile length (so other tiles, and other aggregates
  published) it gives the same bits: a value is carried across the
  tiles, never a composed map, so every chunk's map meets the value in
  the same order.

Inputs are seeded numpy: coefficient sets near matrix4_mb's ranges (the
allpass coefficients inside (-1, 1)), the lookahead line and the states.
No jax: the plain version is the reference here.
"""

import functools

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from dsp_tpu_torch.ops import m4_engine as m4

SEG = 8  # a thread's samples (csrc/m4mb_audio.cu kSeg)
CHUNK = 32 * SEG  # a warp of segments: the kernel's tile
LIMIT = 10.0 ** (-290.0 / 20.0)
CONFIGS = ["matrix4_mb -6", "matrix4_mb direct_path -6", "matrix4_mb phase_flip=false -6",
           "matrix4_mb direct_path,phase_flip=false -6"]
BLOCKS = [2048, 1024, 1056]


@functools.lru_cache(maxsize=None)
def _audio_cfg(words):
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    chain = build_chain_from_string(words, StreamInfo(44100, 2))
    return next(e for e in chain.effects if hasattr(e, "audio")).audio


def _inputs(cfg, B, seed):
    """bands, the line, interp_c, ics and pf_m, seeded."""
    rng = np.random.default_rng(seed)
    nb, ns = m4.N_BANDS, m4.N_SIG_MB
    Nc = B // m4.DOWNSAMPLE_FACTOR
    base = np.concatenate([rng.uniform(-1, 1, (nb, 8)), rng.uniform(-0.8, 0.8, (nb, 2)),
                           rng.uniform(0.3, 1.0, (nb, 2))], axis=1)

    def sets(n):
        c0 = base + 0.05 * rng.standard_normal((n, nb, ns))
        c0[..., 8:10] = np.clip(c0[..., 8:10], -0.85, 0.85)
        c1 = 0.02 * rng.standard_normal((n, nb, ns))
        c2 = 0.01 * rng.standard_normal((n, nb, ns))
        return np.stack([c0, c1, c2], axis=1)

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))  # noqa: E731
    return (t(rng.standard_normal((B, nb, 2)) * 0.1), t(rng.standard_normal((cfg.len, nb, 2)) * 0.1),
            t(sets(1)[0]), t(sets(Nc)), t(rng.standard_normal((nb, 2, 2)) * 0.05))


def _warp_scan(a, b):
    """The shuffle scan inside each warp of 32 segments, over the last axis
    [..., 32]: the inclusive maps (a, b), and the exclusive ones."""
    for d in (1, 2, 4, 8, 16):
        nb = torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]], dim=-1)
        na = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], dim=-1)
        a, b = na, nb
    ea = torch.cat([torch.ones_like(a[..., :1]), a[..., :-1]], dim=-1)
    eb = torch.cat([torch.zeros_like(b[..., :1]), b[..., :-1]], dim=-1)
    return (a, b), (ea, eb)


def _sum_bands(v):
    acc = v[:, 0]
    for k in range(1, v.shape[1]):
        acc = acc + v[:, k]
    return acc


def m4mb_audio_model(cfg, bands, fb_buf, interp_c, ics, pf_m, tile=1):
    """m4mb_audio's (sig, pf_m') computed in csrc/m4mb_audio.cu's partition,
    float64, with tiles of `tile` chunks of 256 samples (the kernel's tile
    is one chunk)."""
    B = bands.shape[0]
    D = m4.DOWNSAMPLE_FACTOR
    u_tab = torch.arange(D).to(torch.float64) / D
    sets = torch.cat([interp_c[None], ics])
    tt = torch.arange(B)
    u = u_tab[(tt + 1) & (D - 1)][:, None, None]
    coefs = sets[(tt + 1) >> 5]
    vals = (coefs[:, 2] * u + coefs[:, 1]) * u + coefs[:, 0]  # [B, 13, 12]
    delayed = torch.cat([fb_buf, bands])[:B]
    s0, s1 = delayed[:, :, 0], delayed[:, :, 1]
    lane = lambda q: torch.cat([s0 * vals[:, :, q] + s1 * vals[:, :, q + 1],  # noqa: E731
                                s0 * vals[:, :, q + 2] + s1 * vals[:, :, q + 3]], dim=1)
    unflipped = lane(4)  # [B, 26]: ls of every band, then rs
    pf_out = pf_m
    y = unflipped
    if cfg.phase_flip:
        nch = -(-B // CHUNK)
        pad = nch * CHUNK - B
        x = unflipped + 1e-15
        c0 = torch.cat([vals[:, :, 8], vals[:, :, 9]], dim=1)
        st = torch.cat([pf_m[:, 0], pf_m[:, 1]])  # [26, 2]: (i0, o0) of each lane
        prev = torch.cat([st[None, :, 0], x[:-1]])

        def segs(v):  # [B, 26] -> [chunks, 26, 32, SEG], the empty samples 0
            v = torch.cat([v, v.new_zeros((pad, v.shape[1]))])
            return v.T.reshape(26, nch, 32, SEG).transpose(0, 1)

        valid = segs(torch.ones((B, 1), dtype=torch.float64).expand(B, 26)) > 0
        xs, cs, ps = segs(x), segs(c0), segs(prev)
        fa = torch.ones((nch, 26, 32), dtype=torch.float64)
        fb = torch.zeros_like(fa)
        for i in range(SEG):
            on = valid[..., i]
            fb = torch.where(on, -cs[..., i] * fb + (ps[..., i] + cs[..., i] * xs[..., i]), fb)
            fa = torch.where(on, -cs[..., i] * fa, fa)
        (ia, ib), (ea, eb) = _warp_scan(fa, fb)
        maps = [(ia[k, :, -1], ib[k, :, -1]) for k in range(nch)]  # each chunk's map of o0
        # tiles of `tile` chunks publish their chunks' maps; a tile's start
        # value is every earlier map applied in order to the block's o0
        starts = []
        for t0 in range(0, nch, tile):
            v = st[:, 1].clone()
            for a, b in maps[:t0]:  # the look-back, from the first tile
                v = a * v + b
            for a, b in maps[t0:t0 + tile]:  # the tile's own chunks
                starts.append(v)
                v = a * v + b
        o0 = ea * torch.stack(starts)[..., None] + eb  # [chunks, 26, 32]
        out = []
        for i in range(SEG):
            r = ps[..., i] + cs[..., i] * (xs[..., i] - o0)
            out.append(r)
            o0 = r
        r = torch.stack(out, dim=-1).transpose(0, 1).reshape(26, nch * CHUNK)[:, :B].T
        y = r - 1e-15
        a, b = maps[-1]
        pf = torch.stack([x[-1], a * starts[-1] + b], dim=-1)  # [26, 2]
        pf_out = torch.stack([pf[:m4.N_BANDS], pf[m4.N_BANDS:]], dim=1)
    nb = m4.N_BANDS
    outs = [_sum_bands(s0 * vals[:, :, 0] + s1 * vals[:, :, 1]),
            _sum_bands(s0 * vals[:, :, 2] + s1 * vals[:, :, 3])]
    eps = 1e-15 / 324
    if cfg.direct_path:
        amb, dire = vals[:, :, 10], vals[:, :, 11]
        outs += [_sum_bands(y[:, :nb] * amb) + eps, _sum_bands(y[:, nb:] * amb) + eps,
                 _sum_bands(unflipped[:, :nb] * dire) + eps,
                 -_sum_bands(unflipped[:, nb:] * dire) + eps]
    else:
        outs += [_sum_bands(y[:, :nb]) + eps, _sum_bands(y[:, nb:]) + eps]
    return torch.stack(outs, dim=1), pf_out


@pytest.mark.parametrize("B", BLOCKS, ids=[f"B={b}" for b in BLOCKS])
@pytest.mark.parametrize("words", CONFIGS)
def test_model_matches_plain_version(words, B):
    """The partition against m4mb_audio_ref within -290 dBFS (sig and the
    states): at 8 whole tiles, at 4, and at 4 and a tile of 4 segments."""
    cfg = _audio_cfg(words)
    ins = _inputs(cfg, B, B + len(words))
    got = m4mb_audio_model(cfg, *ins)
    want = m4.m4mb_audio_ref(cfg, *ins)
    assert got[0].shape == want[0].shape == (B, cfg.n_sig)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= LIMIT
    if not cfg.phase_flip:
        assert torch.equal(got[1], ins[-1])


@pytest.mark.parametrize("tile", [2, 3])
@pytest.mark.parametrize("words", CONFIGS[:2])
def test_model_bits_do_not_depend_on_the_tile_length(words, tile):
    """Tiles of 2 or 3 chunks (512 or 768 samples, so other tiles and a
    partial last one) give the bits of tiles of one chunk, the kernel's,
    over a block of 1056 and one of 2048."""
    cfg = _audio_cfg(words)
    for B in (1056, 2048):
        ins = _inputs(cfg, B, 77 + B)
        base = m4mb_audio_model(cfg, *ins, tile=1)
        other = m4mb_audio_model(cfg, *ins, tile=tile)
        for a, b in zip(base, other):
            assert torch.equal(a, b)


def test_partial_tile_is_the_whole_one_cut():
    """A block of 1056 (4 tiles and a tile of 4 segments) gives, on its
    first 1024 samples, the bits of the same model on those 1024 alone:
    the partial tile's empty segments are identity maps, and the carried
    value reaches it in order."""
    cfg = _audio_cfg(CONFIGS[0])
    ins = _inputs(cfg, 1056, 5)
    whole = m4mb_audio_model(cfg, *ins)
    cut = (ins[0][:1024], ins[1], ins[2], ins[3][:1024 // m4.DOWNSAMPLE_FACTOR], ins[4])
    head = m4mb_audio_model(cfg, *cut)
    assert torch.equal(whole[0][:1024], head[0])


@pytest.mark.parametrize("flip,direct", [(True, True), (False, False)])
def test_model_reads_the_bands_after_the_line(flip, direct):
    """A lookahead line of 100 rows (matrix4_mb's is 2,610 at 44.1 kHz, so
    a block below that reads only the line): the tiles read the line, then
    the block's own bands, within -290 dBFS of the plain version at 1056."""
    cfg = m4.M4MbAudio(100, flip, direct)
    ins = _inputs(cfg, 1056, 11)
    for a, b in zip(m4mb_audio_model(cfg, *ins), m4.m4mb_audio_ref(cfg, *ins)):
        assert float((a - b).abs().max()) <= LIMIT
