#!/usr/bin/env python3
"""Time dsp_tpu_torch's FFT-convolution transforms and splice and the
matrix4 / matrix4_mb event engines on one CUDA card, beside the PyTorch call
that computes the same function where there is one, and compare two trees
of the repository on the same card.

    python3 kernel_times.py                    # this checkout: one JSON line
    python3 kernel_times.py --tree DIR         # the dsp_tpu_torch beside DIR
    python3 kernel_times.py --against DIR      # DIR and this checkout in turns
                                               # (DIR, this, this, DIR), a table
    python3 kernel_times.py --rows engines ... # only the engine rows (or fft,
                                               # cli, td, tdcli, k2, audio,
                                               # k2cli, profile, k1, k1cli,
                                               # k3, k3cli, delay, audiocli,
                                               # audioprofile, meters, resample,
                                               # noise, resamplecli or batch)

DIR is an unpacked checkout of another commit (e.g. `git archive <commit> |
tar -x -C .smoke_tmp/parent`). Each tree runs in a process of its own, since
both packages are named dsp_tpu_torch, and builds its own kernels. Every
row calls only what both trees have: rfft_pack and rfft_pack_f32 without
the kept rows, irfft_crop, irfft_crop_f32, irfft_ola_f32, splice,
splice_f32, and the Upols and resampler steps. A row's times:

* per call: chip_smoke.py's cuda_ms, the mean of 50 calls back to back
  between CUDA events, after a warm-up (for a call this short, the host's
  enqueue);
* device-only: chip_smoke.py's device_ms, the card's kernels as
  torch.profiler records them over 20 calls (5 for a block of 2048 ticks),
  summed, a call; with the kernels a call.

The engine rows time m4_event, m4_event_f32, m4mb_event and m4mb_event_f32
per call and device-only at Nc = 64 and 2048 control ticks (blocks of 2048
and 65536 at 44.1 kHz), with the microseconds a tick. Their inputs are the arguments
`matrix4 -6` and `matrix4_mb -6` hand the engine after 1 s (B = 2048) or one
block (B = 65536) of chip_smoke.py's transient material through the chain
on the card, made once and saved (ENGINE_INPUTS), so that every tree runs the
same ones. With --against each tree also saves the engines' outputs on those
inputs, and the table says whether the two trees' outputs are bit-equal; if
not, the largest difference and whether a decision (a bool or integer leaf)
moved.

The cli rows (asked for alone) run dsp-torch file to file on
chip_smoke.py's 300 s main-path input (written once beside ENGINE_INPUTS),
`matrix4 -6` and `matrix4_mb -6` at -b 2048 and 65536, and give each run's
x realtime (seconds of audio over wall seconds, the kernels built before)
and a digest of its render; the table says whether the trees' renders are
bit-equal.

The td rows time slice C's serial kernels: stats -i (stats_step and
stats_step_f32, K16) at B = 2048 on chip_smoke.py's gate-always-open
quantized noise, a gate-sparse input (loud, -40 dB, loud), silence and one
click, and on the noise at B = 1000 and 65536; the shaped dither
(tpdf_dither and tpdf_dither_f32, K15) in lipshitz and wan9 at B = 2048 and
lipshitz at B = 65536; each from a state one block into the same input,
stereo, made from a seed in each tree, so that with --against the trees'
outputs (every leaf, the sums included) are compared bit for bit. They
also time K2 (biquad_scan, crossfeed's 4 lanes), K2 in float32
(biquad_scan_f32) at B = 2048 and K3 (biquad_scan_df, the flagship's
highpass, 2 lanes, a (hi, lo) state) at B = 1000, for their device-only
time. The tdcli rows run chip_smoke.py's delivery chain (dither lipshitz,
stats -i) through dsp-torch to s16 at -b 2048 and 65536 in float64 and
float32, numpy's generator seeded alike before each run, with each run's
x realtime and a digest of its render.

The k2 rows time K2 in the launches the chain makes with it, each as its
tree calls it: crossfeed's step (CrossfeedEffect.step, float64 and
float32) and matrix4's band-limit pair (biquad_scan_series, or two
biquad_scan launches and the concatenation in a tree without it) at
B = 2048 and 1000, and the float64 per-sample biquad (BiquadEffect.step on the
flagship's highpass 30) at B = 1000; with --against the trees' outputs are
compared bit for bit. The audio rows time m4_audio and m4_audio_f32 at
B = 2048 and 65536 on the arguments `matrix4 -6` hands them on the card
(saved as the engine inputs are), the outputs compared (max |diff| in
dBFS where not bit-equal). The k2cli rows run the flagship at -b 2048 and
1000 in both dtypes and `matrix4 -6` at -b 2048 and 65536 through
dsp-torch to -e double, with x realtime and a digest, and keep matrix4's
renders; with --against, the first run of each tree keeps them until
they are compared (max |diff| in dBFS). The profile rows run the flagship (-b 2048
and 1000, both dtypes) and `matrix4 -6` (-b 2048 in both dtypes, -b 65536
in float64) through CompiledChain.run_blocks under torch.profiler: the
kernels a block, the device ms a block, the largest kernels and the step's
ms a block unprofiled.

The k1 rows time K1 (csrc/lti_blocked.cu) and K11 (csrc/m4_env.cu) per
call and device-only, with the kernels a call, at the main path's shapes
(k1_rows), on seeded inputs; with --against the trees' outputs are
compared (the two designs round differently: the largest difference is
printed). The k1cli rows run `matrix4 -6` and `matrix4_mb -6` at -b 65536
and `matrix4_mb -6` at -b 1000 (the chain rounds it to 1024) and -b 1056
(the bank's L = 1 plan) through dsp-torch in both dtypes, as the k2cli
rows run theirs (renders compared in dBFS).
The profile rows also take the flagship at -b 65536 and `matrix4_mb -6`
at -b 2048 (both dtypes), 65536, 1000 and 1056.

The k3 rows time the run of per-sample biquads and fdl_mac, each as its
tree calls it, on seeded inputs: the flagship's six biquads at B = 1000
(CompiledChain._step of a chain of the six: one biquad_scan_run, or six
launches where the tree has none) and matrix4_mb's fshape and inverse
fshape at B = 2048 (_cascade on each state as the effect keeps it), in
both dtypes, and fdl_mac and fdl_mac_f32 at every shape of chip_smoke.py's
FDL_MAC_SHAPES; with --against the trees' outputs are compared bit for
bit. The k3cli rows run the flagship at -b 1000 and 2048, `matrix4_mb -6`
and `fir` with chip_smoke.py's 65,536-tap filter at -b 2048 through
dsp-torch in both dtypes, as the k2cli rows run theirs.

The audio rows also take m4mb_audio and m4mb_audio_f32 on `matrix4_mb
-6`'s arguments at B = 2048 and 65536 (outputs compared in dBFS where not
bit-equal). The delay rows time the modulated delay's step
(ModDelayEffect.step: the read, the knots and the carried line, as each
tree takes them) at q0 and q2, -m and -M, B = 2048 and 65536, in both
dtypes, and with a 1 kHz modulator and a 0.2 s depth, on seeded inputs; with --against the trees' states and outputs are
compared bit for bit. The audiocli rows run `matrix4_mb -6` at -b 2048 and
65536 and chip_smoke.py's modulated chain at -b 2048 through dsp-torch in
both dtypes, as the k2cli rows run theirs (numpy's generator seeded alike
before each run); the audioprofile rows profile `matrix4_mb -6` (-b 2048 in
both dtypes, 65536) and the modulated chain (-b 2048, both dtypes) as the
profile rows profile theirs.

The meters rows time stats_step in plain mode and with -i (the kernel of
-i untouched, the wrapper's host path shared) and levels_step, float64 and
float32, at B = 2048 and 65536, stereo, a call and device-only, each from a
state one block into seeded quantized noise (outputs compared across the
trees); then where a call's host time goes (cProfile over 2,000 calls of
each at B = 2048, float64: the functions with the most time of their own,
in microseconds a call, cProfile's cost included); then the modulated
chain (their main path) at -b 2048 in both dtypes as the profile rows
profile theirs, and through dsp-torch as the k2cli rows run theirs.

The resample rows time the resampler's step (SpectralResampler.block, as
each tree runs it) at 44.1 to 48 and 192 kHz, 48 to 44.1, x2 and 96 to
44.1 kHz, on 4 and 112 inner blocks (-b 2048 and 65536 at 44.1 kHz),
stereo, in both dtypes, a call and device-only, on seeded inputs (outputs
compared bit for bit); then a call's host path (cProfile,
as the meters rows), and `resample 48k` at -b 2048 in both dtypes
profiled as the profile rows profile theirs. The noise rows time
tpdf_noise and tpdf_noise_f32 with every channel and with the first only,
and NoiseEffect.step with the first only, at B = 2048 and 65536 (outputs
compared bit for bit). The resamplecli rows run `resample 48k` and
`resample 48k matrix4 -6` at -b 2048 through dsp-torch in both dtypes, as
the k2cli rows run theirs (renders compared bit for bit). The batch rows
time CompiledChain.process_batch(xs) on one group of 8 streams of 20 s
(the flagship at -b 2048 and 65536, the modulated chain at 2048), the copy
to the host included, a call and device-only (outputs compared bit for
bit).

The rows are chip_smoke.py's main-path shapes, where chip_smoke.py holds
each kernel against its plain version; this script only times them. Prints
the card's name and power limit (nvidia-smi) with the results. Needs a
CUDA card; exits nonzero without one.
"""

import argparse
import contextlib
import hashlib
import io
import json
import os
import time
import subprocess
import sys
from pathlib import Path

from chip_smoke import CHANNELS, DELIVERY, FLAGSHIP, FS, MATRIX4, MATRIX4_MB, MODULATED, SECONDS, \
    SLICE_C_SEED, card_info, cuda_ms, dbfs, device_ms, flagship_parts, td_signal, transient_signal, \
    write_filter, write_input

ROOT = Path(__file__).resolve().parent
ENGINE_INPUTS = ROOT / ".smoke_tmp" / "engine_inputs.pt"
# (entry, chain, block, float32): Nc = block / 32 ticks
ENGINE_CASES = tuple((f"{name}{sfx}", chain, B, sfx == "_f32")
                     for name, chain in (("m4_event", MATRIX4), ("m4mb_event", MATRIX4_MB))
                     for sfx in ("", "_f32") for B in (2048, 65536))


def rows():
    """(name, the port's call, the library call or None) at the main path's
    shapes, seeded."""
    import numpy as np
    import torch

    from dsp_tpu_torch.ops import fft_conv as fc
    from dsp_tpu_torch.ops import resample_ops as ro

    dev = torch.device("cuda")
    rng = np.random.default_rng(20290)

    def normal(*shape, dtype=torch.float64):
        return torch.as_tensor(rng.standard_normal(shape) * 0.3, dtype=dtype, device=dev)

    a, x = normal(2048, 2), normal(2048, 2)
    a32, x32, add32 = (t.float() for t in (a, x, normal(2048, 2)))
    packed, packed32 = torch.cat([a, x]), torch.cat([a32, x32])
    Y = torch.fft.rfft(packed, n=4096, dim=0).contiguous()
    Y64 = Y.to(torch.complex64)
    cols32 = normal(588, 8, dtype=torch.float32)
    rs = ro.SpectralResampler(44100, 48000)
    Yr = ro.resample_fold(torch.fft.rfft(cols32.double(), n=1176, dim=0).contiguous(), rs.fold)
    ov32 = normal(640, 2, dtype=torch.float32)
    h = rng.standard_normal((2, 1 << 16)) * 0.01
    up = fc.UpolsConv(h, 2048)
    st64 = {k: torch.as_tensor(v, device=dev) for k, v in up.state0().items()}
    st32 = {k: v.float() for k, v in st64.items()}
    xr = normal(4 * 588, 2)
    ov = normal(640, 2)
    return [
        ("rfft_pack N=4096 C=2", lambda: fc.rfft_pack(a, x, 4096),
         lambda: torch.fft.rfft(packed, n=4096, dim=0)),
        ("rfft_pack_f32 N=4096 C=2", lambda: fc.rfft_pack_f32(x32, 4096, a32),
         lambda: torch.fft.rfft(packed32, n=4096, dim=0)),
        ("rfft_pack_f32 N=1176 C=8", lambda: fc.rfft_pack_f32(cols32, 1176),
         lambda: torch.fft.rfft(cols32, n=1176, dim=0)),
        ("irfft_crop N=4096 C=2", lambda: fc.irfft_crop(Y, 4096, 2048, 2048),
         lambda: torch.fft.irfft(Y, n=4096, dim=0)[2048:]),
        ("irfft_crop_f32 N=4096 C=2, addend", lambda: fc.irfft_crop_f32(Y, 4096, 2048, 2048, add32),
         lambda: torch.fft.irfft(Y64, n=4096, dim=0)[2048:]),
        ("irfft_ola_f32 N=1280 C=8", lambda: ro.irfft_ola_f32(Yr, 1280, ov32, 640 / 588), None),
        ("splice L=2048 C=2", lambda: fc.splice(a, x, 2048, 0, 2048),
         lambda: torch.cat([a[2048:], x])),
        ("splice_f32 L=2048 C=2", lambda: fc.splice_f32(a32, x32, 2048, 0, 2048),
         lambda: torch.cat([a32[2048:], x32])),
        ("Upols step (fir 64k, B=2048)", lambda: up.step(st64, x), None),
        ("Upols step float32", lambda: up.step(st32, x32), None),
        ("resample 48k step (4 inner blocks)", lambda: rs.block(ov, xr), None),
        ("resample 48k step float32", lambda: rs.block(ov32, xr.float()), None),
    ]


def _engine_chain(chain, B, f32):
    """The chain on the card, and its upmix effect (whose ``ctl`` is the
    engine's control object, M4Control or M4MbControl)."""
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    cc = CompiledChain(build_chain_from_string(chain, StreamInfo(FS, CHANNELS)), B,
                       dtype=torch.float32 if f32 else None, device="cuda")
    return cc, next(e for e in cc._runtime_effects if hasattr(e, "ctl"))


def engine_inputs(path, cases=ENGINE_CASES):
    """{entry@B: the arguments the chain hands the m4_engine wrapper
    `entry` after its first (ctl or the audio config), on the CPU}: made on
    the card by the chain itself (a spy on the wrapper catches the
    arguments of the block after the warm-up) unless `path` holds them
    already."""
    import torch

    from dsp_tpu_torch.ops import m4_engine as m4

    if path.exists():
        return torch.load(path)
    got = {}
    for entry, chain, B, f32 in cases:
        cc, _ = _engine_chain(chain, B, f32)
        warm = 21 if B == 2048 else 1
        x = torch.as_tensor(transient_signal((warm + 1) * B / FS + 0.01),
                            dtype=torch.float32 if f32 else torch.float64, device="cuda")
        x = x[: (warm + 1) * B].reshape(warm + 1, B, CHANNELS)
        cc.run_blocks(x[:warm])
        fn, caught = getattr(m4, entry), []

        def spy(*args, fn=fn, caught=caught):
            caught.append(args[1:])
            return fn(*args)

        spy.launches = 0  # the wrapper counts its launches on the module's name
        setattr(m4, entry, spy)
        try:
            cc.run_blocks(x[warm:])
        finally:
            setattr(m4, entry, fn)
        got[f"{entry}@{B}"] = _to(caught[-1], "cpu")
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(got, path)
    return got


def _to(tree, device):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def engine_rows(inputs_path):
    """(name, the engine's call, Nc) for each of ENGINE_CASES."""
    from dsp_tpu_torch.ops import m4_engine as m4

    inputs = engine_inputs(inputs_path)
    out = []
    for entry, chain, B, f32 in ENGINE_CASES:
        _, e = _engine_chain(chain, B, f32)
        ctl = e.ctl
        args = _to(inputs[f"{entry}@{B}"], "cuda")
        fn = getattr(m4, entry)
        out.append((f"{entry} Nc={B // 32}", lambda fn=fn, ctl=ctl, args=args: fn(ctl, *args),
                    B // 32))
    return out


CLI_CASES = ((MATRIX4, 2048), (MATRIX4, 65536), (MATRIX4_MB, 2048), (MATRIX4_MB, 65536))


def cli_rows(inputs_path):
    """Each of CLI_CASES through dsp-torch on the card: x realtime and a
    digest of the render."""
    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.cli.main import main as cli_main

    src = inputs_path.parent / "cli_in.wav"
    if not src.exists():
        src.parent.mkdir(parents=True, exist_ok=True)
        write_input(src, SECONDS)
    kernels.load()
    os.environ["DSP_TPU_TORCH_DEVICE"] = "cuda"
    dst = inputs_path.parent / f"cli_out_{os.getpid()}.wav"
    out = []
    for chain, block in CLI_CASES:
        argv = ["-b", str(block), "-q", str(src), "-o", "-e", "double", str(dst), *chain.split()]
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"kernel_times: dsp-torch {' '.join(argv)} exited {rc}")
        out.append({"name": f"{chain} -b {block}", "x_realtime": SECONDS / wall,
                    "digest": hashlib.sha256(dst.read_bytes()).hexdigest()[:16]})
    dst.unlink()
    return out


TD_STATS = (("noise", 2048), ("gate-sparse", 2048), ("silence", 2048), ("click", 2048),
            ("noise", 1000), ("noise", 65536))
TD_DITHER = (("lipshitz", 2048), ("wan9", 2048), ("lipshitz", 65536))


def td_rows():
    """(name, the call, reps) of the td rows, their inputs seeded."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.dither import DitherEffect
    from dsp_tpu_torch.effects.stats import StatsEffect
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import time_domain as td

    dev = torch.device("cuda")
    rng = np.random.default_rng(20311)
    out = []
    for dt, sfx in ((torch.float64, ""), (torch.float32, "_f32")):
        step = getattr(td, f"stats_step{sfx}")
        for kind, B in TD_STATS:
            e = StatsEffect("stats", StreamInfo(FS, CHANNELS), np.ones(CHANNELS, dtype=bool), None,
                            80, True)
            table = torch.as_tensor(e._insert_table, dtype=dt, device=dev)
            s0 = {k: torch.as_tensor(v, device=dev) for k, v in e.state0().items()}
            s0 = {k: v.to(dt) if v.is_floating_point() else v for k, v in s0.items()}
            x = torch.as_tensor(td_signal(kind, 2 * B, rng), dtype=dt, device=dev)
            s1 = step(s0, x[:B].contiguous(), table)
            xb = x[B:].contiguous()
            out.append((f"stats_step{sfx} -i {kind} B={B}",
                        lambda step=step, s1=s1, xb=xb, table=table: step(s1, xb, table),
                        5 if B > 8192 else 50))
        fn = getattr(td, f"tpdf_dither{sfx}")
        for shape, B in TD_DITHER:
            e = DitherEffect("dither", StreamInfo(48000 if shape.startswith("wan") else FS,
                                                  CHANNELS),
                             np.ones(CHANNELS, dtype=bool), shape, 16.0, 16, False, False,
                             seed=4242)
            args = [torch.as_tensor(v, dtype=None if v.dtype == bool else dt, device=dev)
                    for v in (e.n_mult, e.q_mult0, e.q_mult1, e.enabled, e.fir)]
            st = {k: torch.as_tensor(v, device=dev) for k, v in e.state0().items()}
            eh = torch.as_tensor(rng.standard_normal((9, CHANNELS)) * 1e-5, dtype=dt, device=dev)
            x = torch.as_tensor(rng.standard_normal((B, CHANNELS)) * 0.3, dtype=dt, device=dev)
            ins = (st["key"], x, eh, st["nprev"].to(dt), *args)
            out.append((f"tpdf_dither{sfx} {shape} B={B}",
                        lambda fn=fn, ins=ins, mode=e.mode: fn(*ins, mode),
                        5 if B > 8192 else 50))
    # K2, K2 in float32 and K3, at chip_smoke.py's shapes
    _, scans = flagship_parts()
    A, Bv, c0 = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in scans["crossfeed (companion, 4 lanes)"])
    x = torch.as_tensor(rng.standard_normal((2048, 4)) * 0.3, device=dev)
    st = torch.as_tensor(rng.standard_normal((4, 2)) * 1e-2, device=dev)
    out.append(("biquad_scan (K2) crossfeed B=2048",
                lambda: iir.biquad_scan(A, Bv, c0, st, x), 50))
    effects = build_chain_from_string(FLAGSHIP, StreamInfo(FS, CHANNELS)).effects
    cf = next(e for e in effects if e.name == "crossfeed")
    hp = next(e for e in effects if e.name == "highpass")
    A32, Bv32, c032 = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                       for a in (cf._ss32_A, cf._ss32_Bv, cf._ss32_c0))
    x32 = x.float()
    st32 = st.float()
    out.append(("biquad_scan_f32 (K2 f32) crossfeed B=2048",
                lambda: iir.biquad_scan_f32(A32, Bv32, c032, st32, x32), 50))
    Ah, Bh, ch = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                  for a in (hp._ss_A, hp._ss_Bv, hp._ss_c0))
    xh = torch.as_tensor(rng.standard_normal((1000, CHANNELS)) * 0.3, dtype=torch.float32,
                         device=dev)
    sth = torch.stack(iir.split_f64(torch.as_tensor(rng.standard_normal((CHANNELS, 2)) * 1e-2,
                                                    device=dev)))
    out.append(("biquad_scan_df (K3) highpass B=1000",
                lambda: iir.biquad_scan_df(Ah, Bh, ch, sth, xh), 50))
    return out


# the k2 rows: K2 in the launches the chain makes with it, each called as
# its tree calls it (the band-limit pair: two K2 launches and the
# concatenation where the tree has no biquad_scan_series)
K2_BLOCKS = (2048, 1000)


def k2_rows():
    """(name, the call, reps) of the k2 rows, their inputs seeded:
    crossfeed's step (float64 and float32, stereo) and matrix4's band-limit
    pair at B = 2048 and 1000, and the float64 per-sample biquad (the
    flagship's highpass 30) at B = 1000."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops import iir

    dev = torch.device("cuda")
    rng = np.random.default_rng(20312)
    effects = build_chain_from_string(FLAGSHIP, StreamInfo(FS, CHANNELS)).effects
    cf = next(e for e in effects if e.name == "crossfeed")
    hp = next(e for e in effects if e.name == "highpass")
    m4e = build_chain_from_string(MATRIX4, StreamInfo(FS, CHANNELS)).effects[0]
    hp_args = [torch.as_tensor(getattr(m4e, k), device=dev) for k in ("A_hp", "B_hp", "c0_hp")]
    lp_args = [torch.as_tensor(getattr(m4e, k), device=dev) for k in ("A_lp", "B_lp", "c0_lp")]

    def band_limit(st, x):
        if hasattr(iir, "biquad_scan_series"):
            A, Bv, c0 = (torch.cat([h, l]) for h, l in zip(hp_args, lp_args))
            return lambda: iir.biquad_scan_series(A, Bv, c0, st, x)

        def two_launches():
            s1, y1 = iir.biquad_scan(*hp_args, st[:2], x)
            s2, y2 = iir.biquad_scan(*lp_args, st[2:], y1)
            return torch.cat([s1, s2]), y2
        return two_launches

    out = []
    for B in K2_BLOCKS:
        x = torch.as_tensor(rng.standard_normal((B, CHANNELS)) * 0.3, device=dev)
        st = torch.as_tensor(rng.standard_normal((4, 2)) * 1e-2, device=dev)
        for dt, sfx in ((torch.float64, ""), (torch.float32, " float32")):
            xd, sd = x.to(dt), st.to(dt)
            out.append((f"crossfeed step{sfx} B={B}", lambda xd=xd, sd=sd: cf.step(sd, xd), 50))
        out.append((f"matrix4 band-limit pair B={B}", band_limit(st, x), 50))
        if B % 128:  # a block K1 takes runs the biquad blocked, not per sample
            sp = torch.as_tensor(rng.standard_normal((2, CHANNELS, 2)) * 1e-2, device=dev)
            sp[1] *= 1e-9
            out.append((f"biquad per-sample float64 (highpass 30) B={B}",
                        lambda sp=sp, x=x: hp.step(sp, x), 50))
    return out


# the k3 rows: the flagship's six biquads at -b 1000 (the per-sample path)
# as the chain steps them, and matrix4_mb's two cascades at -b 2048
# calls a k3 row's per-call time averages (the host's enqueue at these
# shapes: more calls than the other rows' 50, for a steadier mean)
K3_REPS = 500
K3_BIQUADS = ("eq 1k 1.0 +3 eq 3.5k 0.8 -2 lowshelf 90 0.7071s +4 highshelf 10k 0.7071s -2 "
              "lowpass 18k 0.7071 highpass 30 0.7071")


def k3_rows():
    """(name, the call, reps) of the k3 rows, their inputs seeded, each
    called as its tree's chain calls it: the flagship's six biquads at
    B = 1000 in both dtypes (CompiledChain._step of a chain of the six: one
    run, or six per-sample launches in a tree without it), matrix4_mb's
    fshape and inverse fshape at B = 2048 in both dtypes (_cascade on each
    state as the effect keeps it, with the caller's transposed copy), and
    fdl_mac and fdl_mac_f32 at every shape of chip_smoke.py's
    FDL_MAC_SHAPES."""
    import numpy as np
    import torch

    from chip_smoke import FDL_MAC_SHAPES
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops import fft_conv as fc

    dev = torch.device("cuda")
    rng = np.random.default_rng(20314)
    out = []
    for dt in (torch.float64, torch.float32):
        sfx = "" if dt == torch.float64 else " float32"
        cc = CompiledChain(build_chain_from_string(K3_BIQUADS, StreamInfo(FS, CHANNELS)), 1000,
                           dtype=dt, device="cuda")
        raw = rng.standard_normal((6, 2, CHANNELS, 2)) * 1e-2
        raw[:, 1] *= 1e-9
        states = [torch.as_tensor(r, dtype=dt, device=dev) for r in raw]
        x = torch.as_tensor(rng.standard_normal((1000, CHANNELS)) * 0.3, dtype=dt, device=dev)
        out.append((f"flagship's six biquads B=1000{sfx}",
                    lambda cc=cc, states=states, x=x: cc._step(states, x), K3_REPS))
        e = build_chain_from_string("matrix4_mb -6", StreamInfo(FS, CHANNELS)).effects[1]
        n_sig = e.audio.n_sig
        fsh = torch.as_tensor(rng.standard_normal((4, 2)) * 1e-2, dtype=dt, device=dev)
        inv = torch.as_tensor(rng.standard_normal((n_sig, 2, 2)) * 1e-2, dtype=dt, device=dev)
        pair = torch.as_tensor(rng.standard_normal((2048, 2)) * 0.3, dtype=dt, device=dev)
        sig = torch.as_tensor(rng.standard_normal((2048, n_sig)) * 0.3, dtype=dt, device=dev)

        def cascades(e=e, fsh=fsh, inv=inv, pair=pair, sig=sig):
            f, y_f = e._cascade("fsh", fsh.reshape(2, 2, 2), pair)
            i, y_i = e._cascade("inv", inv.transpose(0, 1), sig)
            return f.reshape(4, 2), y_f, i.transpose(0, 1).contiguous(), y_i
        out.append((f"matrix4_mb's two cascades B=2048{sfx}", cascades, K3_REPS))
    for K, NB, _ in FDL_MAC_SHAPES:
        X = torch.as_tensor(rng.standard_normal((NB, CHANNELS))
                            + 1j * rng.standard_normal((NB, CHANNELS)), device=dev)
        H = torch.as_tensor(rng.standard_normal((K, NB, CHANNELS))
                            + 1j * rng.standard_normal((K, NB, CHANNELS)), device=dev)
        fdl = torch.as_tensor(rng.standard_normal((K, NB, CHANNELS, 2)), device=dev)
        out.append((f"fdl_mac K={K} NB={NB}", lambda X=X, H=H, f=fdl: fc.fdl_mac(X, H, f),
                    K3_REPS))
        out.append((f"fdl_mac_f32 K={K} NB={NB}",
                    lambda X=X, H=H, f=fdl.float(): fc.fdl_mac_f32(X, H, f), K3_REPS))
    return out


def k1_rows():
    """(name, the call, reps) of the k1 rows, their inputs seeded: K1 on
    the flagship cascade at B = 2048 and 65536 (float64) and 2048
    (float32), on matrix4_mb's bank at B = 2048 (L = 128) and 1056 (its
    L = 1 plan), and K1-df with the (hi, lo) output on the bank at 2048
    and on matrix4's float32 band-limit at B = 1000 (L = 1); K11's m4_env
    at B = 2048 and 65536 and m4_env_f32 at 2048, m4mb_env (13 bands)
    without and with the frequency mask's weights at 2048, and
    m4mb_env_f32 with them."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    dev = torch.device("cuda")
    rng = np.random.default_rng(20313)
    plan, _ = flagship_parts()
    mb = next(e for e in build_chain_from_string(MATRIX4_MB, StreamInfo(FS, CHANNELS)).effects
              if hasattr(e, "_bank_plan"))
    m4e = build_chain_from_string(MATRIX4, StreamInfo(FS, CHANNELS)).effects[0]
    out = []

    def k1(name, pl, B, dtype=torch.float64, df=False):
        x = torch.as_tensor(rng.standard_normal((B, pl.C)) * 0.3, device=dev, dtype=dtype)
        st = torch.as_tensor(rng.standard_normal((2, pl.C, pl.n)) * 1e-2, device=dev)
        st = torch.stack(iir.split_f64(st[0])) if dtype == torch.float32 else st
        fn = (lambda: iir.lti_blocked(pl, st, x)) if not df else (
            lambda: iir.lti_blocked_df(pl, st, x))
        out.append((f"{name} B={B}", fn, 50 if B <= 2048 else 10))

    k1("K1 flagship", plan, 2048)
    k1("K1 flagship", plan, 65536)
    k1("K1-df flagship float32", plan, 2048, torch.float32)
    k1("K1 bank (C=26, n=40, L=128)", mb._bank_plan(2048), 2048)
    k1("K1 bank at L = 1", mb._bank_plan(1056), 1056)
    k1("K1-df bank float32 (hi, lo) out", mb._bank_plan(2048), 2048, torch.float32, True)
    k1("K1-df matrix4 band-limit float32 at L = 1", m4e._bp_plan(1000), 1000, torch.float32, True)
    g = m4e.g_env
    w = torch.as_tensor(m4.band_mix_weights(0.5), device=dev)
    for B in (2048, 65536):
        ybp = torch.as_tensor(rng.standard_normal((B, 2)) * 0.1, device=dev)
        env = torch.as_tensor(rng.uniform(0, 0.05, 8), device=dev)
        out.append((f"m4_env B={B}", lambda ybp=ybp, env=env: m4.m4_env(ybp, env, g),
                    50 if B == 2048 else 10))
        if B == 2048:
            hi = ybp.float()
            lo, eh = (ybp - hi.double()).float(), env.float()
            el = (env - eh.double()).float()
            out.append((f"m4_env_f32 B={B}",
                        lambda hi=hi, lo=lo, eh=eh, el=el: m4.m4_env_f32(hi, lo, eh, el, g), 50))
    bands = torch.as_tensor(rng.standard_normal((2048, m4.N_BANDS, 2)) * 0.1, device=dev)
    env = torch.as_tensor(rng.uniform(0, 0.05, (m4.N_BANDS, 8)), device=dev)
    out.append(("m4mb_env B=2048", lambda: m4.m4mb_env(bands, env, g), 50))
    out.append(("m4mb_env with w B=2048", lambda: m4.m4mb_env(bands, env, g, w), 50))
    hi = bands.float()
    lo, eh = (bands - hi.double()).float(), env.float()
    el = (env - eh.double()).float()
    out.append(("m4mb_env_f32 with w B=2048", lambda: m4.m4mb_env_f32(hi, lo, eh, el, g, w), 50))
    return out


AUDIO_CASES = tuple((f"{name}{sfx}", chain, B, sfx == "_f32")
                    for name, chain in (("m4_audio", MATRIX4), ("m4mb_audio", MATRIX4_MB))
                    for sfx in ("", "_f32") for B in (2048, 65536))
AUDIO_INPUTS = "audio_inputs.pt"


def audio_rows(inputs_path):
    """(name, the call, reps) of m4_audio, m4mb_audio and their float32
    forms at B = 2048 and 65536, on the arguments `matrix4 -6` and
    `matrix4_mb -6` hand them after 1 s (B = 2048) or one block (B = 65536)
    of chip_smoke.py's transient material through the chain on the card,
    made once and saved beside ENGINE_INPUTS."""
    from dsp_tpu_torch.ops import m4_engine as m4

    inputs = engine_inputs(inputs_path.parent / AUDIO_INPUTS, AUDIO_CASES)
    out = []
    for entry, chain, B, f32 in AUDIO_CASES:
        _, e = _engine_chain(chain, B, f32)
        args = _to(inputs[f"{entry}@{B}"], "cuda")
        fn = getattr(m4, entry)
        out.append((f"{entry} B={B}", lambda fn=fn, cfg=e.audio, args=args: fn(cfg, *args),
                    50 if B == 2048 else 10))
    return out


# the delay rows: ModDelayEffect.step of delay -m/-M at these (quality, -M,
# block, dtype, depth in samples, modulator bandwidth in Hz): 0.5 ms at the
# default 1 Hz; a 1 kHz modulator (about 10 knot rows a tile); a 0.2 s
# depth (its line window read through L1)
DELAY_CASES = tuple((qual, mono, B, dtype, 0.5e-3 * FS, 1.0) for dtype in ("float64", "float32")
                    for qual in (0, 2) for mono in (False, True) for B in (2048, 65536)) + tuple(
    (qual, False, B, dtype, samples, fc) for dtype in ("float64", "float32")
    for qual, samples, fc in ((2, 0.5e-3 * FS, 1000.0), (1, 0.2 * FS, 1.0)) for B in (2048, 65536))


def delay_rows():
    """(name, the call, reps) of the modulated delay's step as each tree
    takes it (mod_delay and, in a tree without the carried line in the
    kernel, the effect's splice) at each of DELAY_CASES, stereo, from a
    state one block in, on inputs made from a seed alike in each tree: the
    state and output are compared bit for bit."""
    import numpy as np
    import torch

    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.delay import ModDelayEffect

    rng = np.random.default_rng(15)
    out = []
    for qual, mono, B, dtype, samples, fc in DELAY_CASES:
        dt = getattr(torch, dtype)
        e = ModDelayEffect("delay", StreamInfo(FS, CHANNELS), np.ones(CHANNELS, dtype=bool),
                           samples, fc, mono, qual, seed=31337)
        st = {k: torch.as_tensor(v, device="cuda") for k, v in e.state0().items()}
        st = {k: v.to(dt) if v.is_floating_point() else v for k, v in st.items()}
        x0, x = (torch.as_tensor(rng.standard_normal((B, CHANNELS)) * 0.3, dtype=dt,
                                 device="cuda") for _ in range(2))
        st, _ = e.step(st, x0)
        extra = "" if (samples, fc) == (0.5e-3 * FS, 1.0) else f" depth {e.depth:g} fc {fc:g}"
        out.append((f"mod_delay step q{qual} {'-M' if mono else '-m'}{extra} B={B} {dtype}",
                    lambda e=e, st=st, x=x: e.step(st, x), 50 if B == 2048 else 10))
    return out


# the meters rows: stats plain and -i and levels, both dtypes, at these blocks;
# the modulated chain (their main path) profiled at -b 2048 in both dtypes
METER_BLOCKS = (2048, 65536)
METER_PROFILE_CASES = ((MODULATED, 2048, "float64", 64), (MODULATED, 2048, "float32", 64))
METER_CLI_CASES = ((MODULATED, 2048, "float64"), (MODULATED, 2048, "float32"))


def _meter_states(dt, B, rng):
    """A stats state (plain and -i) one block into quantized noise and a
    levels state, on the card in dtype dt, with the next block: seeded."""
    import numpy as np
    import torch

    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.stats import StatsEffect
    from dsp_tpu_torch.ops import time_domain as td

    x = np.round(rng.standard_normal((2 * B, CHANNELS)) * 0.3 * 32768) / 32768
    x0, x1 = (torch.as_tensor(v, dtype=dt, device="cuda") for v in (x[:B], x[B:]))
    out = {}
    for interp in (False, True):
        e = StatsEffect("stats", StreamInfo(FS, CHANNELS), np.ones(CHANNELS, dtype=bool), None,
                        80, interp)
        table = torch.as_tensor(e._insert_table, dtype=dt, device="cuda") if interp else None
        s0 = {k: torch.as_tensor(v, device="cuda") for k, v in e.state0().items()}
        s0 = {k: v.to(dt) if v.is_floating_point() else v for k, v in s0.items()}
        out[interp] = (td.stats_step(s0, x0, table), table)
    g = 1.0 - float(np.exp(-1.0 / (FS * 0.3)))
    lv = td.levels_step(*(torch.zeros(CHANNELS, dtype=dt, device="cuda") for _ in range(3)),
                        x0, g)
    return out, lv, x1, g


def meter_rows():
    """(name, the call, reps) of the meters rows: stats_step plain and -i
    and levels_step, float64 and float32, at METER_BLOCKS, stereo, each
    from a state one block in, on inputs made from a seed alike in each
    tree."""
    import numpy as np
    import torch

    from dsp_tpu_torch.ops import time_domain as td

    rng = np.random.default_rng(16)
    out = []
    for dt, sfx in ((torch.float64, ""), (torch.float32, " float32")):
        for B in METER_BLOCKS:
            st, lv, x, g = _meter_states(dt, B, rng)
            reps = 50 if B == 2048 else 10
            for interp, label in ((False, "plain"), (True, "-i")):
                s1, table = st[interp]
                out.append((f"stats_step {label} B={B}{sfx}",
                            lambda s1=s1, x=x, table=table: td.stats_step(s1, x, table), reps))
            out.append((f"levels_step B={B}{sfx}", lambda lv=lv, x=x, g=g: td.levels_step(*lv, x, g),
                        reps))
    return out


# the resample rows: the step at the rate pairs the repo runs, at -b 2048 and
# 65536 at 44.1 kHz (4 and 112 inner blocks), in both dtypes; the profile
# and CLI runs of `resample 48k` and the 48 kHz upmix
RESAMPLE_PAIRS = ((44100, 48000), (44100, 192000), (48000, 44100), (44100, 88200),
                  (96000, 44100))
RESAMPLE_INNER = (4, 112)
RESAMPLE_PROFILE_CASES = (("resample 48k", 2048, "float64", 64),
                          ("resample 48k", 2048, "float32", 64))
RESAMPLE_CLI_CASES = tuple((chain, 2048, dtype) for chain in ("resample 48k",
                                                              "resample 48k matrix4 -6")
                           for dtype in ("float64", "float32"))


def resample_rows():
    """(name, the call, reps) of the resample rows: SpectralResampler.block
    as each tree runs it, stereo, on inputs made from a seed alike in each
    tree (outputs compared bit for bit)."""
    import numpy as np
    import torch

    from dsp_tpu_torch.ops import resample_ops as ro

    rng = np.random.default_rng(17)
    out = []
    for dt, sfx in ((torch.float64, "float64"), (torch.float32, "float32")):
        for pair in RESAMPLE_PAIRS:
            rs = ro.SpectralResampler(*pair)
            for n in RESAMPLE_INNER:
                x, ov = (torch.as_tensor(rng.standard_normal((rows, CHANNELS)) * 0.3, dtype=dt,
                                         device="cuda")
                         for rows in (n * rs.in_len, rs.out_len))
                reps = 50 if n == 4 else 10
                name = f"resample step {pair[0]}->{pair[1]} n={n} {sfx}"
                out.append((name, lambda rs=rs, ov=ov, x=x: rs.block(ov, x), reps))
    return out


# process_batch's one group: (chain, block, dtype) on BATCH_STREAMS streams
# of BATCH_SECONDS s, chip_smoke.py's devices_phase cases
BATCH_CASES = (("flagship", FLAGSHIP, 2048, "float64"), ("flagship", FLAGSHIP, 65536, "float64"),
               ("modulated", MODULATED, 2048, "float64"))
BATCH_STREAMS, BATCH_SECONDS = 8, 20


def batch_rows():
    """(name, the call, reps) of the batch rows: CompiledChain.process_batch(xs)
    (one group of BATCH_STREAMS streams on the card, the copy to the host
    included) for each of BATCH_CASES, on inputs made from a seed alike in
    each tree, numpy's generator seeded before each chain is built (outputs
    compared bit for bit)."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    n = BATCH_SECONDS * FS
    xs = np.random.default_rng(95).standard_normal((BATCH_STREAMS, n, CHANNELS)) * 0.3
    out = []
    for label, words, B, dt in BATCH_CASES:
        np.random.seed(SLICE_C_SEED)
        cc = CompiledChain(build_chain_from_string(words, StreamInfo(FS, CHANNELS)), B,
                           dtype=getattr(torch, dt), device="cuda")
        out.append((f"process_batch {label} -b {B} {dt}, {BATCH_STREAMS} x {BATCH_SECONDS} s",
                    lambda cc=cc: torch.from_numpy(cc.process_batch(xs)), 5))
    return out


NOISE_BLOCKS = (2048, 65536)


def noise_rows():
    """(name, the call, reps) of the noise rows: tpdf_noise and
    tpdf_noise_f32 with every channel and with the first only, and
    NoiseEffect.step with the first only, at NOISE_BLOCKS, stereo, seeded
    (outputs compared bit for bit)."""
    import numpy as np
    import torch

    from dsp_tpu_torch.core.prng import prng_key
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.noise import NoiseEffect
    from dsp_tpu_torch.ops import time_domain as td

    rng = np.random.default_rng(18)
    key = prng_key(4242).to("cuda")
    sel = torch.tensor([True, False], device="cuda")
    e = NoiseEffect("noise", StreamInfo(FS, CHANNELS), np.array([True, False]), 1e-8)
    out = []
    for dt, sfx in ((torch.float64, "float64"), (torch.float32, "float32")):
        fn = td.tpdf_noise_f32 if dt == torch.float32 else td.tpdf_noise
        for B in NOISE_BLOCKS:
            x = torch.as_tensor(rng.standard_normal((B, CHANNELS)) * 0.3, dtype=dt, device="cuda")
            reps = 50 if B == 2048 else 10
            out += [(f"tpdf_noise B={B} {sfx}", lambda fn=fn, x=x: fn(key, x, 1e-8), reps),
                    (f"tpdf_noise B={B} {sfx} first channel",
                     lambda fn=fn, x=x: fn(key, x, 1e-8, sel), reps),
                    (f"NoiseEffect.step B={B} {sfx} first channel", lambda x=x: e.step(key, x),
                     reps)]
    return out


def step_host_rows(calls=2000):
    """Where a call's host time goes (as host_rows): the resampler's step
    at 48 kHz on 4 inner blocks and tpdf_noise and NoiseEffect.step (the
    first channel) at B = 2048, float64."""
    import numpy as np
    import torch

    from dsp_tpu_torch.core.prng import prng_key
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.noise import NoiseEffect
    from dsp_tpu_torch.ops import resample_ops as ro
    from dsp_tpu_torch.ops import time_domain as td

    rng = np.random.default_rng(19)
    rs = ro.SpectralResampler(44100, 48000)
    x, ov = (torch.as_tensor(rng.standard_normal((rows, CHANNELS)) * 0.3, device="cuda")
             for rows in (4 * rs.in_len, rs.out_len))
    xn = torch.as_tensor(rng.standard_normal((2048, CHANNELS)) * 0.3, device="cuda")
    key = prng_key(4242).to("cuda")
    e = NoiseEffect("noise", StreamInfo(FS, CHANNELS), np.array([True, False]), 1e-8)
    return host_rows(calls, (("resample step 48k n=4", lambda: rs.block(ov, x)),
                             ("tpdf_noise", lambda: td.tpdf_noise(key, xn, 1e-8)),
                             ("NoiseEffect.step first channel", lambda: e.step(key, xn))))


def host_rows(calls=2000, fns=None):
    """Where a call's host time goes: cProfile over `calls` calls of each
    (name, fn) of fns (by default stats_step plain, stats_step -i and
    levels_step at B = 2048 in float64), the functions with the most time
    of their own, in microseconds a call (cProfile's own cost included)."""
    import cProfile
    import pstats

    import numpy as np
    import torch

    from dsp_tpu_torch.ops import time_domain as td

    if fns is None:
        st, lv, x, g = _meter_states(torch.float64, 2048, np.random.default_rng(17))
        fns = (("stats_step plain", lambda: td.stats_step(st[False][0], x)),
               ("stats_step -i", lambda: td.stats_step(st[True][0], x, st[True][1])),
               ("levels_step", lambda: td.levels_step(*lv, x, g)))
    out = []
    for name, fn in fns:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(calls):
            fn()
        prof.disable()
        torch.cuda.synchronize()
        stats = pstats.Stats(prof).stats
        total = sum(v[2] for v in stats.values()) * 1e6 / calls
        top = sorted(((f"{Path(k[0]).name}:{k[1]}({k[2]})", v[2] * 1e6 / calls)
                      for k, v in stats.items()), key=lambda kv: -kv[1])[:10]
        out.append({"name": f"host {name}" + ("" if "48k" in name else " B=2048"),
                    "host_us": total, "host_top": top})
    return out


# the renders of the audiocli rows: the two kernels' chains, `matrix4_mb -6`
# at -b 2048 and 65536 and chip_smoke.py's modulated chain (numpy's generator
# seeded before each run), in both dtypes
AUDIOCLI_CASES = tuple((chain, block, dtype) for chain, block in (
    (MATRIX4_MB, 2048), (MATRIX4_MB, 65536), (MODULATED, 2048))
    for dtype in ("float64", "float32"))


# the renders of the k2cli rows: (chain, block, dtype)
K2CLI_CASES = tuple((FLAGSHIP, block, dtype) for block in (2048, 1000)
                    for dtype in ("float64", "float32")) + tuple(
    (MATRIX4, block, "float64") for block in (2048, 65536))


# the renders of the k1cli rows: the upmixes where K1 and K11 set the pace
# (-b 65536), and matrix4_mb at -b 1000 (the chain's block 1024, an
# L = 128 plan) and at -b 1056 (off the 128 grid: the bank's L = 1 plan),
# in both dtypes
K1CLI_CASES = tuple((chain, block, dtype) for chain, block in (
    (MATRIX4, 65536), (MATRIX4_MB, 65536), (MATRIX4_MB, 1000), (MATRIX4_MB, 1056))
    for dtype in ("float64", "float32"))


# the renders of the k3cli rows: the flagship at -b 1000 (its six biquads
# per sample) and 2048, `matrix4_mb -6` and `fir` 64k (the Upols step, K =
# 32) at -b 2048, in both dtypes
K3CLI_CASES = tuple((chain, block, dtype) for chain, block in (
    (FLAGSHIP, 1000), (FLAGSHIP, 2048), (MATRIX4_MB, 2048), ("fir {f64k}", 2048))
    for dtype in ("float64", "float32"))


def k2cli_rows(inputs_path, keep, cases=K2CLI_CASES):
    """Each of `cases` (K2CLI_CASES, K1CLI_CASES, K3CLI_CASES or
    AUDIOCLI_CASES) through dsp-torch on the card to -e double, numpy's
    generator seeded before each run: x realtime, a digest of the render,
    and the renders but the flagship's kept as `keep`_<i>.wav for the
    comparison of the trees (the flagship's are held by digest)."""
    import numpy as np

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.cli.main import main as cli_main

    src = inputs_path.parent / "cli_in.wav"
    if not src.exists():
        src.parent.mkdir(parents=True, exist_ok=True)
        write_input(src, SECONDS)
    f64k = inputs_path.parent / "f64k.wav"  # chip_smoke.py's 65,536-tap filter
    if not f64k.exists():
        write_filter(f64k, 1 << 16, seed=0xBE)
    kernels.load()
    os.environ["DSP_TPU_TORCH_DEVICE"] = "cuda"
    out = []
    for i, (chain, block, dtype) in enumerate(cases):
        dst = keep.with_name(f"{keep.stem}_{i}.wav")
        os.environ["DSP_TPU_TORCH_DTYPE"] = dtype
        words = chain.format(f64k=f64k).split()
        argv = ["-b", str(block), "-q", str(src), "-o", "-e", "double", str(dst), *words]
        np.random.seed(SLICE_C_SEED)  # the chains that draw seeds draw alike
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"kernel_times: dsp-torch {' '.join(argv)} exited {rc}")
        name = {FLAGSHIP: "flagship", MODULATED: "modulated"}.get(chain, chain.format(f64k="64k"))
        row = {"name": f"{name} -b {block} {dtype}", "x_realtime": SECONDS / wall,
               "digest": hashlib.sha256(dst.read_bytes()).hexdigest()[:16]}
        if chain == FLAGSHIP:  # held byte for byte: the digest is enough
            dst.unlink()
        else:
            row["render"] = str(dst)
        out.append(row)
    os.environ.pop("DSP_TPU_TORCH_DTYPE")
    return out


# the profile rows: (chain, block, dtype, blocks profiled)
PROFILE_CASES = ((FLAGSHIP, 2048, "float64", 64), (FLAGSHIP, 2048, "float32", 64),
                 (FLAGSHIP, 1000, "float64", 64), (FLAGSHIP, 1000, "float32", 64),
                 (MATRIX4, 2048, "float64", 64), (MATRIX4, 2048, "float32", 64),
                 (MATRIX4, 65536, "float64", 8), (FLAGSHIP, 65536, "float64", 8),
                 (MATRIX4_MB, 2048, "float64", 64), (MATRIX4_MB, 2048, "float32", 64),
                 (MATRIX4_MB, 65536, "float64", 8),
                 (MATRIX4_MB, 1000, "float64", 64), (MATRIX4_MB, 1056, "float64", 64))


# the audioprofile rows: the chains of this slice's two kernels
AUDIO_PROFILE_CASES = ((MATRIX4_MB, 2048, "float64", 64), (MATRIX4_MB, 2048, "float32", 64),
                       (MATRIX4_MB, 65536, "float64", 8), (MODULATED, 2048, "float64", 64),
                       (MODULATED, 2048, "float32", 64))


def profile_rows(cases=PROFILE_CASES):
    """Each of `cases` run through CompiledChain.run_blocks on the card
    (chip_smoke.py's inputs: transients for matrix4, noise for the rest):
    the step's ms a block unprofiled (host clock to a
    synchronize), then under torch.profiler the kernels the card ran a
    block, its device ms a block and the largest kernels by device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    rng = np.random.default_rng(13)
    out = []
    for chain, block, dtype, n in cases:
        dt = getattr(torch, dtype)
        cc = CompiledChain(build_chain_from_string(chain, StreamInfo(FS, CHANNELS)), block,
                           dtype=dt, device="cuda")
        B = cc.block_frames
        if chain in (MATRIX4, MATRIX4_MB):
            x = transient_signal((n + 4) * B / FS + 0.01)[: (n + 4) * B]
        else:
            x = rng.standard_normal(((n + 4) * B, CHANNELS)) * 0.1
        xs = torch.as_tensor(x, dtype=dt, device="cuda").reshape(n + 4, B, CHANNELS)
        cc.run_blocks(xs[:4])
        xs = xs[4:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cc.run_blocks(xs)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        by_name, kernels = {}, 0
        for _ in range(3):  # a profile can come back empty: take it again
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                cc.run_blocks(xs)
                torch.cuda.synchronize()
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
                    kernels += 1
            if kernels:
                break
        name = {FLAGSHIP: "flagship", MODULATED: "modulated"}.get(chain, chain)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out.append({"name": f"{name} -b {block} {dtype}", "step_ms": step_ms,
                    "kernels_a_block": kernels / n, "device_ms_a_block": sum(by_name.values()),
                    "top": [[k[:60], v] for k, v in top]})
    return out


TDCLI_CASES = tuple((dtype, block) for dtype in ("float64", "float32") for block in (2048, 65536))


def tdcli_rows(inputs_path):
    """The delivery chain through dsp-torch to s16 on the card, in each
    dtype and block of TDCLI_CASES: x realtime and a digest of the render."""
    import numpy as np

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.cli.main import main as cli_main

    src = inputs_path.parent / "cli_in.wav"
    if not src.exists():
        src.parent.mkdir(parents=True, exist_ok=True)
        write_input(src, SECONDS)
    kernels.load()
    os.environ["DSP_TPU_TORCH_DEVICE"] = "cuda"
    dst = inputs_path.parent / f"cli_out_{os.getpid()}.wav"
    out = []
    for dtype, block in TDCLI_CASES:
        os.environ["DSP_TPU_TORCH_DTYPE"] = dtype
        argv = ["-b", str(block), "-q", str(src), "-o", "-e", "s16", str(dst), *DELIVERY.split()]
        np.random.seed(SLICE_C_SEED)
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"kernel_times: dsp-torch {' '.join(argv)} exited {rc}")
        out.append({"name": f"delivery {dtype} -b {block}", "x_realtime": SECONDS / wall,
                    "digest": hashlib.sha256(dst.read_bytes()).hexdigest()[:16]})
    os.environ.pop("DSP_TPU_TORCH_DTYPE")
    dst.unlink()
    return out


def measure(which, inputs_path, save=None):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: CUDA is not available")
    if which == "cli":
        return cli_rows(inputs_path)
    if which == "tdcli":
        return tdcli_rows(inputs_path)
    if which == "k2cli":
        return k2cli_rows(inputs_path, save)
    if which == "k1cli":
        return k2cli_rows(inputs_path, save, K1CLI_CASES)
    if which == "k3cli":
        return k2cli_rows(inputs_path, save, K3CLI_CASES)
    if which == "audiocli":
        return k2cli_rows(inputs_path, save, AUDIOCLI_CASES)
    if which == "profile":
        return profile_rows()
    if which == "audioprofile":
        return profile_rows(AUDIO_PROFILE_CASES)
    if which == "resamplecli":
        return k2cli_rows(inputs_path, save or inputs_path.parent / "resamplecli.pt",
                          RESAMPLE_CLI_CASES)
    out = []
    if which in ("td", "k2", "audio", "k1", "k3", "delay", "meters", "resample", "noise", "batch"):
        outputs = {}
        made = {"td": td_rows, "k2": k2_rows, "audio": lambda: audio_rows(inputs_path),
                "k1": k1_rows, "k3": k3_rows, "delay": delay_rows,
                "meters": meter_rows, "resample": resample_rows, "noise": noise_rows,
                "batch": batch_rows}[which]()
        for name, kern, reps in made:
            r = {"name": name, "ms": cuda_ms(kern, reps)}
            r["device_ms"], r["kernels"] = device_ms(kern, min(reps, 20))
            out.append(r)
            if save is not None:
                outputs[name] = _to(kern(), "cpu")
        if save is not None:
            torch.save(outputs, save)
        if which == "meters":
            out += host_rows() + profile_rows(METER_PROFILE_CASES) + k2cli_rows(
                inputs_path, save or inputs_path.parent / "meters.pt", METER_CLI_CASES)
        if which == "resample":
            out += step_host_rows() + profile_rows(RESAMPLE_PROFILE_CASES)
        return out
    if which in ("all", "engines"):
        outputs = {}
        for name, kern, Nc in engine_rows(inputs_path):
            ms = cuda_ms(kern, 50 if Nc <= 64 else 10)
            dev_ms, kernels = device_ms(kern, 20 if Nc <= 64 else 5)
            out.append({"name": name, "ms": ms, "us_a_tick": ms * 1e3 / Nc, "device_ms": dev_ms,
                        "device_us_a_tick": dev_ms * 1e3 / Nc, "kernels": kernels})
            if save is not None:
                outputs[name] = _to(kern(), "cpu")
        if save is not None:
            torch.save(outputs, save)
    if which == "engines":
        return out
    for name, kern, lib in rows():
        r = {"name": name, "ms": cuda_ms(kern, 50)}
        r["device_ms"], r["kernels"] = device_ms(kern)
        if lib is not None:
            r["library_ms"] = cuda_ms(lib, 50)
            r["library_device_ms"], r["library_kernels"] = device_ms(lib)
        out.append(r)
    return out


def run_tree(tree, which, inputs_path, save):
    """This script on the dsp_tpu_torch beside `tree`, in a process of its
    own; returns its rows."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree", str(tree),
                           "--rows", which, "--inputs", str(inputs_path), "--save", str(save)],
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"kernel_times: {tree}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["rows"]


def compare_outputs(before, after):
    """{row: "bit-equal", or the largest difference and whether a decision
    moved} between two trees' saved engine outputs."""
    import torch

    a_all, b_all = torch.load(before), torch.load(after)
    verdict = {}
    for name in a_all:
        flat_a, flat_b = [], []
        _flatten(a_all[name], flat_a)
        _flatten(b_all[name], flat_b)
        if len(flat_a) == len(flat_b) and all(torch.equal(a, b) for a, b in zip(flat_a, flat_b)):
            verdict[name] = "bit-equal"
            continue
        worst, moved = 0.0, False
        for a, b in zip(flat_a, flat_b):
            if a.dtype.is_floating_point:
                if a.numel():
                    worst = max(worst, float((a.double() - b.double()).abs().max()))
            elif not torch.equal(a, b):
                moved = True
        verdict[name] = (f"differs: max |diff| {worst:.3e} ({dbfs(worst):.1f} dBFS), "
                         f"{'a decision moved' if moved else 'no decision moved'}")
    return verdict


def render_diff(before, after):
    """The largest difference of two -e double renders, in dBFS."""
    import numpy as np

    from chip_smoke import read_wav

    (na, a), (nb, b) = read_wav(Path(before)), read_wav(Path(after))
    if na != nb:
        return f"{na} and {nb} frames"
    err = float(np.abs(a - b).max())
    return f"max |diff| {err:.3e}, {dbfs(err):.1f} dBFS"


def _flatten(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=None)
    ap.add_argument("--against", type=Path, default=None)
    ap.add_argument("--rows", choices=("all", "fft", "engines", "cli", "td", "tdcli", "k2",
                                       "audio", "k2cli", "profile", "k1", "k1cli", "k3", "k3cli",
                                       "delay", "audiocli", "audioprofile", "meters", "resample",
                                       "noise", "resamplecli", "batch"),
                    default="all")
    ap.add_argument("--inputs", type=Path, default=ENGINE_INPUTS)
    ap.add_argument("--save", type=Path, default=None)
    args = ap.parse_args()
    if args.against is None:
        tree = (args.tree or ROOT).resolve()
        sys.path.insert(0, str(tree))
        import dsp_tpu_torch

        if Path(dsp_tpu_torch.__file__).resolve().parent.parent != tree:
            raise SystemExit(f"kernel_times: dsp_tpu_torch imported from {dsp_tpu_torch.__file__}")
        rows_out = measure(args.rows, args.inputs, args.save)
        print(json.dumps({"tree": str(tree), "card": card_info(), "rows": rows_out}))
        return 0
    card = card_info()
    order = [("before", args.against), ("after", ROOT), ("after", ROOT), ("before", args.against)]
    saves = [args.inputs.parent / f"engine_out_{i}_{label}.pt"
             for i, (label, _) in enumerate(order)]
    runs = []
    for i, ((label, tree), save) in enumerate(zip(order, saves)):
        runs.append((label, run_tree(tree, args.rows, args.inputs, save)))
        if i >= 2:  # the renders of the first run of each tree are compared
            for r in runs[-1][1]:
                if "render" in r:
                    Path(r["render"]).unlink()
    print(f"card: {card}; order: before, after, after, before")
    verdict = (compare_outputs(saves[0], saves[1])
               if args.rows in ("all", "engines", "td", "k2", "audio", "k1", "k3", "delay",
                                "meters", "resample", "noise", "batch")
               else {})
    keys = ("ms", "us_a_tick", "device_ms", "device_us_a_tick", "kernels", "library_ms",
            "library_device_ms", "x_realtime", "digest", "render", "step_ms", "kernels_a_block",
            "device_ms_a_block", "top", "host_us", "host_top")
    table = []
    for i, first in enumerate(runs[0][1]):
        name = first["name"]
        row = {"name": name}
        for label in ("before", "after"):
            got = [r[i] for lab, rr in runs for r in [rr] if lab == label]
            for k in keys:
                vals = [g[k] for g in got if k in g]
                if vals:
                    row[f"{label}_{k}"] = vals
        table.append(row)
        if "before_x_realtime" in row:
            same = len(set(row["before_digest"] + row["after_digest"])) == 1
            if not same and "before_render" in row:
                row["renders"] = render_diff(row["before_render"][0], row["after_render"][0])
            print(f"{name}: " + "; ".join(
                f"{label} {'/'.join(f'{v:.1f}' for v in row[f'{label}_x_realtime'])}x realtime"
                for label in ("before", "after"))
                + f"; renders {'bit-equal' if same else 'differ'} across the runs"
                + (f" ({row['renders']})" if "renders" in row else ""))
            continue
        if "before_kernels_a_block" in row:
            print(f"{name}: " + "; ".join(
                f"{label} {'/'.join(f'{v:.2f}' for v in row[f'{label}_kernels_a_block'])} "
                f"kernels a block, device "
                f"{'/'.join(f'{v:.4f}' for v in row[f'{label}_device_ms_a_block'])} ms a block, "
                f"step {'/'.join(f'{v:.4f}' for v in row[f'{label}_step_ms'])} ms a block, top "
                + ", ".join(f"{k} {v:.4f}" for k, v in row[f"{label}_top"][0][:4])
                for label in ("before", "after")))
            continue
        if "before_host_us" in row:
            print(f"{name}: " + "; ".join(
                f"{label} {'/'.join(f'{v:.1f}' for v in row[f'{label}_host_us'])} us a call "
                "under cProfile, most: " + ", ".join(
                    f"{k} {v:.1f}" for k, v in row[f"{label}_host_top"][0][:8])
                for label in ("before", "after")))
            continue
        if "before_us_a_tick" in row:
            row["outputs"] = verdict[name]
            print(f"{name}: " + "; ".join(
                f"{label} {'/'.join(f'{v:.4f}' for v in row[f'{label}_ms'])} ms a call, "
                f"{'/'.join(f'{v:.3f}' for v in row[f'{label}_us_a_tick'])} us a tick, "
                f"device-only {'/'.join(f'{v:.3f}' for v in row[f'{label}_device_us_a_tick'])}"
                for label in ("before", "after")) + f"; outputs {verdict[name]}")
            continue
        if name in verdict:
            row["outputs"] = verdict[name]
        print(f"{name}: " + "; ".join(
            f"{label} {'/'.join(f'{v:.4f}' for v in row[f'{label}_ms'])} ms a call, "
            f"{'/'.join(f'{v:.4f}' for v in row[f'{label}_device_ms'])} ms device-only, "
            f"{row[f'{label}_kernels'][0]} kernels"
            + (f", library {'/'.join(f'{v:.4f}' for v in row[f'{label}_library_ms'])} ms a call, "
               f"{'/'.join(f'{v:.4f}' for v in row[f'{label}_library_device_ms'])} ms device-only"
               if f"{label}_library_ms" in row else "")
            for label in ("before", "after"))
            + (f"; outputs {verdict[name]}" if name in verdict else ""))
    for _, rr in runs[:2]:
        for r in rr:
            if "render" in r:
                Path(r["render"]).unlink()
    print(json.dumps({"card": card, "rows": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
