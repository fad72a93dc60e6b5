#!/usr/bin/env python3
"""Smoke run of dsp_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper card,
nvcc and PyTorch built for CUDA. It

1. prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from dsp_tpu_torch/csrc with nvcc;
2. runs each kernel (K1 lti_blocked, K2 biquad_scan; K5-K7 rfft_pack with
   the engines' kept rows (held to splice_ref exactly), fdl_mac, irfft_crop
   and splice, the transforms at one size of each path of their plan: one
   pass (4096, 1176, 3430), two (131072) and a global pass (2·8221), each
   held to the number of kernels its plan launches; K14 mod_delay, K15
   tpdf_dither, K16
   stats_step, K17 levels_step and K18-noise tpdf_noise; K8 resample_fold,
   K11 m4_env, K9 + K10 m4_event and K12 + K13 m4_audio) against its plain
   PyTorch version on the same inputs at the main path's shapes: the
   earlier slices' within -200 dBFS, slice C's equal (noise, dither, the
   stats decisions), within 1e-12 relative (sums, levels) or -280 dBFS (the
   modulated read); K16's -i walk also on gate-sparse, silent and click
   input and at B = 1000 and 65536, K15 in every shape at B = 1000 and
   2048 with zero and -0.0 error histories and lipshitz and wan9 at 65536
   (stats_interp_cases, dither_cases: every leaf bit-equal but the sums).
   K8, the resampler's step in one launch (csrc/resample.cu), in both
   dtypes at 44.1 -> 48 and 192 kHz, 48 -> 44.1, x2 and 96 -> 44.1 kHz on
   1, 4 and 112 inner blocks: one launch a step by the library's count,
   bit-equal to the route it replaced composed on the card from the kept
   wrappers, within -280 dBFS of the plain step (float32: one ulp of the
   scale); `resample 44101` on the route of three launches (rfft_pack,
   resample_fold, irfft_ola: the passes, the overlap-add and the fold, no
   torch op), bit-equal to the parent route, within -200 dBFS of the plain
   step; on both routes the float64 step takes a float32 overlap as its
   float64 value; the fold alone equal
   to its plain version (resample_phase). K18's noise (and its float32
   form) at B = 2048, 1000, 65536 and 1, with and without a channel
   selection and through NoiseEffect.step: one launch a call by the
   library's count, key' and y bit-equal to the plain version
   (noise_cases). K9-K13 over 3 blocks of transient material for v4, v1,
   direct_path, phase_flip=false,shelf=none,lowpass=none and the 48 kHz
   block of Nc = 80, and over one block of 65536 (Nc = 2048: the event
   engine's chunk pipeline wraps many times): the engine's decisions
   equal, its floats within 1e-12 relative, the audio within -280 dBFS
   (m4_audio timed a call and device-only at B = 2048 and 65536). K1 and
   K11, the one-launch designs of csrc/lti_blocked.cu and csrc/m4_env.cu,
   are also held absolutely: K1's y and end state within K1_ABS = 1e-15
   (the flagship at B = 2048 and 65536, the bank in every configuration),
   K11's ticks and envelopes within ENV_ABS = 4e-15 (float32: hi + lo),
   and each form's call is one kernel by the library's count of its
   launches and by torch.profiler's, where CUPTI records the kernels
   (one_launch, which prints its device-only time). K1 also on cascades
   of 40 and 75 biquads (n = 80, 150), whose tables it cannot all stage
   in shared memory, within K1_ABS; and K1, K11 and m4mb_audio interleaved
   on their shared look-back scratch with different tile counts, the
   aggregates' storage filled with each launch's tag, bit-equal to fresh
   scratches (lookback_phase). A run of per-sample biquads in one launch
   (biquad_scan_run, biquad_scan_run_df: csrc/biquad_scan.cu's
   dsp_biquad_scan_run) in its four forms, 2 and 6 stages, at B = 100,
   1000, 1056, 2048 and 65536, bit-equal to the separate launches it
   replaces and one launch a call by the library's count
   (biquad_run_phase); fdl_mac and fdl_mac_f32 at every main-path shape
   with the shifted FDL equal to the plain version, a call and
   device-only; and the leaner wrappers of both refusing every bad input
   (lean_wrapper_refusals). K14's modulated step (ModDelayEffect.step) is
   one launch of csrc/mod_delay.cu by the library's count and no splice,
   its carried line bit-equal to the plain version's, over blocks of 2048,
   2048 and 64 (shorter than the line), with 1 kHz and 5 kHz modulators
   (float64; every case within MOD_DELAY_DBFS) and a 0.2 s depth (a line
   window too long to stage), in both dtypes. K16's plain mode (tiles over
   the card, csrc/lookback.cuh's protocol) and K17 (the same, the carried
   value through carry_max_affine) in both dtypes at B = 2048, 1000, 65536
   and 1 and with a limit inside a tile (meter_cases): stats' decisions
   equal, sums and meters within 1e-12 relative (float32: one ulp), each
   call made twice and bit-equal, and each call, stats -i's too, one
   launch by the library's count (kernels.meter_launches).
   matrix4_mb's (slice F): K1 on its 13-band bank, K11 m4mb_env over 13 lanes, K9 + K10 m4mb_event (the
   13 engines coupled through their thresholds every tick) and K12 + K13
   m4mb_audio, over 3 blocks of transients in seven configurations (v4,
   v1, direct_path, butterworth with freq_mask, 48 kHz, block 1056 for the
   bank's L = 1 plan, 192 kHz), one block of 65536 and one block each at
   441, 470.4 and 768 kHz (HIGH_RATE_MB: the 13 bands' rings in a device
   scratch from 461.9 kHz; also in float32): decisions and
   thresholds equal, floats
   within 1e-13 relative, the bank and the audio within -290 dBFS;
   m4mb_audio (and m4mb_audio_f32) one launch a call by the library's
   count, with the phase flip and without it, at B = 2048, 1056 and 65536
   (mb_audio_launches, device-only time printed). The wrappers of the
   resampler's step, irfft_ola and the noise refuse every bad input
   (lean_wrapper_refusals). Times
   each kernel, its plain version and, where one PyTorch call computes the
   same function, that call, with CUDA events, and computes each kernel's
   roofline bound from its shapes; the transforms, the splices and their
   PyTorch calls also device-only (timed_row: torch.profiler's kernel time
   a call, beside the kernels a call), since a back-to-back call this
   short times the host's enqueue. Then renders the 4 s program signal at
   -b 65536 and holds it to bench_goldens/resample.npz and matrix4.npz
   (dsp_tpu f64) within -200 dBFS, and replays bench_goldens/matrix4_mb.npz's
   control stream through the card's audio path within -120 dBFS. Slice
   H1's stream-axis forms (split_kernel_phase): K1 and K1-df, crossfeed's
   step, the run, the lone K2/K3, rfft_pack, fdl_mac, irfft_crop and
   splice, the resampler's step and its route of three launches, each in
   both dtypes, at S = 3 streams one launch a call (the route: the count of
   one stream's call), each stream bit-equal to a one-stream launch and the
   whole within its plain version on the card, timed at S = 1 and 8 (the
   rows named <kernel>@S); slice H2a's the same way (upmix_forms): matrix4's
   band-limit pair, m4_env, m4_event (its lanes the streams), m4_audio,
   m4mb_env (also with the frequency mask), m4mb_event (a block a stream)
   and m4mb_audio, each in both dtypes, on stream states warmed by 2 s of
   transients, held to their plain versions at the one-stream rows'
   tolerances; slice H2b's (td_forms): tpdf_noise (every channel, one),
   tpdf_dither (lipshitz, flat, sloped2), stats_step (-i, plain),
   levels_step and mod_delay (q0, q2, -m, -M), each in both dtypes, on
   per-stream states from one-stream runs of their own seeds and lengths
   (distinct keys, histories, sums, meters, phases and lines);
3. writes 300 s of stereo 44.1 kHz float64 wav (seeded noise plus sines), a
   full track, and runs the port's CLI on it file to file: the flagship
   chain at the default block (2048) and at -b 65536; then the FFT
   convolution paths, with seeded flat-noise filters it writes itself:
   `fir` 64k taps at -b 65536 (OLS) and 2048 (Upols), `fir_p` 1M taps at
   2048 (Nupols) and -b 65536 (Upols), and the shipped linear-phase
   crossover example (remix, forward and time-reversed biquads); then
   slice C's two chains at the default block: "delivery" to s16 (gain,
   a Thiran-fractional delay on one channel, lipshitz dither at auto 16
   bits, stats -i) and "modulated" to double (delay -M q2, noise, sloped2
   dither, stats, levels); then slices D and E's upmixes at the default
   block: `matrix4 -6` (44.1 kHz to 4 channels; also at -b 65536, where
   the event engine sets the pace) and, on 60 s, `resample 48k matrix4 -6`
   (a 48 kHz quad: the rate change, blocks of 2352 in and 2560 out) and
   `resample 44101` (the resampler's route of three launches, blocks of
   44,100 frames); then slice F's:
   `matrix4_mb -6` (also at -b 65536) and, on 60 s, bench.py's `mixed`
   chain (an EQ, a fractional delay, a 4,096-tap filter, matrix4_mb) and
   examples/matrix4_mb_2_4 (6 channels) and `matrix4_mb -6` at -b 1000
   (the chain's block 1024) and -b 1056 (the bank's L = 1 plan, which K1
   runs in chunks of 32), each compared on its
   first 5 s (the engine's chaotic start held to MB_ONSET); then the
   float32 phase (slices J1 and J2): K1-df lti_blocked_f32 on the flagship
   cascade, on matrix4_mb's bank with its (hi, lo) output (also its L = 1
   plan at B = 1056) and on matrix4's band-limit (L = 128 at B = 2048,
   L = 1 at B = 1000), each one kernel a call, K3
   biquad_scan_df at B = 1000 and 100 (and with a single float32 state at
   matrix4_mb's fshape and inverse widths), K2 in float32 biquad_scan_f32 on
   crossfeed's lanes, a (hi, lo) state handed from K1-df to K3 and back,
   and the float32 resampler step (rfft_pack_f32, the fold,
   irfft_ola_f32) to 48 and 192 kHz, with irfft_ola_f32 also on plans of
   two passes, against their plain versions (float32
   outputs within one float32 ulp of their scale, (hi, lo) sums within
   1e-13 relative), timed as above; slice J3's float32 kernels the same
   way: K5-K7 in float32 (rfft_pack_f32 with its head, fdl_mac_f32 with a
   float32 FDL, irfft_crop_f32, splice_f32) and the OLS, Upols and Nupols
   steps on the card against their plain versions on the CPU, and
   matrix4's and matrix4_mb's K9-K13 in float32 (m4_env_f32,
   m4_event_f32, m4_audio_f32; after K3 and K1-df, m4mb_env_f32,
   m4mb_event_f32, m4mb_audio_f32) over 3 blocks of transients in eight
   configurations and one block of 65536 for each, decisions equal; each
   event engine's microseconds a tick at Nc = 64 and 2048 on one line;
   both upmixes' float32 audio paths replaying their float64 control on 10 s of two signals, against a
   float64 audio path fed the same float32-rounded inputs within -120
   dBFS; and
   DSP_TPU_TORCH_DTYPE=float32 dsp-torch on the same 300 s, the flagship
   at blocks 2048 and 1000, `resample 48k`, `matrix4 -6`, `matrix4_mb -6`,
   `fir` 64k at blocks 65536 and 2048 and `fir_p` 1M at 2048, each held on
   the whole run against the port's float64 run on the card (kept from
   step 3 where it ran there) within -120 dBFS, matrix4_mb's free run
   within MB_F32_LATE_DBFS from MB_ONSET[0] s on (its chaotic start within
   MB_F32_FREE_DBFS), its float32 kernels launched and no float64 kernel.
   Each run must produce the expected frame count, launch its kernels
   (their launch counts are zeroed just before the run), and match the
   port's CPU run on the first 10 s: within -200 dBFS, the delivery
   chain's s16 samples exactly, the modulated chain within -280 dBFS
   (numpy's global generator is seeded alike before both runs, so both
   draw the same keys), the 48 kHz upmix from 5 s on (its first seconds
   within -100 dBFS, see ONSET). The delivery chain's stats table, from a
   card run and a CPU run of the CLI on the first 10 s, must be equal
   character for character. Last, slice J4's float32 runs of the delivery
   (s16) and modulated (double) chains (float32_time_domain_cli): their
   float32 kernels launched and no float64 one, the first 10 s against the
   port's float32 CPU run (s16 equal; within one float32 ulp), the float32
   stats table equal on card and CPU, and the whole 300 s against the
   float64 renders by the stats table's DC, peak and RMS, with the RMS of
   the difference printed beside the level two independent noise and
   dither draws predict. Between the main path and the float32 phase,
   slice H1's split phase (split_phase): the flagship (both dtypes), `fir`
   64k and `lowpass 18k 0.7071 resample 96k` through dsp-torch on the same
   300 s, sequential and with DSP_TPU_SPLIT=8, × realtime and kernels a
   host step (equal at S = 1 and 8) printed; the float64 splits' segment 0
   bit-equal to the main path's sequential render and the whole within
   -150 dBFS, the float32 split within -120 dBFS of the float64 render;
   then process_batch on 8 streams of the flagship and `fir` 64k (and of
   the chains that run the other stream-axis forms) against process_array
   on the card, within 1e-12; then slice H2a's batches (batch_upmix_phase):
   `matrix4 -6` and `matrix4_mb -6` on 8 streams of 20 s at -b 2048 and
   65536 in both dtypes, and matrix4_mb at 470.4 kHz (its rings in the
   device scratch) on 2 streams, each stream bit-equal to process_array on
   the card, kernels a host step equal at S = 1 and 8, the batch's rate
   against process_array's printed, every upmix stream-axis form launched;
   then slice H2b's (batch_td_phase): the delivery chain (dither at 16
   bits) and the modulated chain the same way, at -b 2048 and 65536 in
   both dtypes, every time-domain stream-axis row launched; then slice
   H2c's (devices_phase): process_batch(xs, devices=["cuda:0", "cuda:0"])
   (two groups of 4 streams stepped in turn) against one group of 8 on 8
   streams of 20 s, the flagship at -b 2048 and 65536, the dry run's
   MC_CHAIN at -b 2048 and 65536, the modulated chain at -b 2048 and the
   flagship in float32 at -b 2048: bit-equal, twice one group's kernels,
   both routes timed in turns; the float64 cases at -b 2048 also with one
   group on the card and one on the CPU (a replica of the chain on the
   other device), the chain built on either, within -200 dBFS of one
   group and the one group's kernels launched; and the port's dry run on
   the two groups;
   then slice A's: the flagship through dsp-torch from the port's sgen
   codec (10 s of two sines) on the card, held to the same command on the
   CPU within -200 dBFS (sgen_cli_phase), and dsp-torch -p and -P of the
   flagship, which must print the gnuplot program (plot_phase). The float32
   delivery and modulated chains' CPU runs and the stats tables' CPU runs
   go to worker processes ahead of the phases that read them;
4. runs 96 blocks of the Nupols path (fir_p 1M at B = 2048), 320 of the
   delivery chain in float64 and in float32, 16 each of matrix4 and matrix4_mb and of the float32
   flagship (blocks 2048 and 1000), resample and upmixes, with the input on
   the card under torch.cuda.set_sync_debug_mode("error"): a step must not
   wait on the device; then times 128 blocks of each slice C chain (in
   both dtypes), each
   upmix (matrix4_mb and the mixed chain among them) and each float32 run
   (the upmixes and `fir` 64k at block 2048 among them) in both dtypes,
   and profiles them (torch.profiler: kernels a block, beside the count
   before the one-launch transforms, which no chain may exceed, and at most
   3 for the Upols step of `fir` 64k and 4 for the float32 resampler, and
   the limits K1's one launch sets (MOST_KERNELS_A_BLOCK); device time a
   block by kernel, the device's share), and 8 blocks of the flagship,
   `matrix4 -6` and `matrix4_mb -6` at -b 65536 (PROFILE_65536);
5. prints the kernels' record as one JSON line, then as the last line
   {"ok": true, "device": {...}}.

Any failed phase exits nonzero before the last line. Without CUDA, or
without the dsp_tpu_torch package beside this script, it exits nonzero and
prints no result. It imports nothing of jax or dsp_tpu.
"""

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FS = 44100
CHANNELS = 2
FLAGSHIP = (
    "gain -3 eq 1k 1.0 +3 eq 3.5k 0.8 -2 lowshelf 90 0.7071s +4 highshelf 10k 0.7071s -2 "
    "lowpass 18k 0.7071 highpass 30 0.7071 crossfeed 700 4.5 st2ms ms2st"
)
# f64 rounding amplified by the 30 Hz highpass's pole sensitivity (~1e5)
# stays near -220 dBFS; -200 leaves a margin and is far inside the -120 dBFS
# budget of dsp_tpu's parity tests
LIMIT_DBFS = -200.0
COMPARE_SECONDS = 10
# worker processes for the main path's CPU references (CpuReferences):
# the card's host has 8 cores, and the card's runs keep one busy
REFERENCE_WORKERS = 5
SECONDS = 300  # the main path's input: a full track
# the linear-phase crossover that ships with the repo: remix 2 -> 4, forward
# biquads (K1) and time-reversed ones (the reverse IIR on fdl_mac)
CROSSOVER = ROOT / "examples" / "crossover_lr4_2kHz_riir_linphase"


# slice C's chains (ROADMAP.md): a CD master to s16 with a speaker-distance
# fractional delay, and a modulated, dithered double render
DELIVERY = "gain -1 :1 delay -f 0.37m : dither lipshitz stats -i"
MODULATED = "delay -M 0.5m -q 2 10m noise -90 dither sloped2 16 stats levels"
SLICE_C_SEED = 20263  # numpy's global generator, seeded before each run
# the chains whose stats tables stats_table_check holds: (label, words, enc)
TABLE_CHAINS = (("delivery", DELIVERY, "s16"), ("modulated", MODULATED, "double"))
# slices D and E (bench.py:494): the 4-channel upmix of a CD master, and a
# 48 kHz quad upmix, which exercises the rate change and both quanta (588
# in, 32 after it: -b 2048 becomes 2352 in, 2560 out)
MATRIX4 = "matrix4 -6"
UPMIX48 = "resample 48k matrix4 -6"
# slice F (bench.py:495-496): the 13-band upmix of a CD master, the `mixed`
# chain before it (an EQ, a fractional speaker delay, a 4,096-tap room
# filter) and the 6-channel example
MATRIX4_MB = "matrix4_mb -6"
MB_EXAMPLE = ROOT / "examples" / "matrix4_mb_2_4"
# one biquad alone at a block K1 does not take: the per-sample biquad's own
# launch (the flagship's six at -b 1000 run as one run)
LONE_BIQUAD = "highpass 30 0.7071"


def mixed_chain(f4k):
    return f"eq 1k 1.0 +3 delay -f 0.3m fir {f4k} matrix4_mb -6"


# matrix4_mb's engine is chaotic where a band sits at crosstalk level: at the
# stream's start the phase-linearising FIR's pre-ringing leaves the upper
# bands at ~1e-15, and the card's and the CPU's FFT rounding (~1e-16) is a
# large part of them (tests/test_torch_matrix4_mb.py shows the same between
# dsp_tpu and the port on the CPU). The runs print their difference a
# second; the first MB_ONSET[0] s are held to MB_ONSET[1], the rest of the
# MB_COMPARE_SECONDS compared to LIMIT_DBFS (the plain engine is a Python
# loop a tick: the CPU run takes ~6 s a second of audio). Measured on an
# NVIDIA H100 80GB HBM3 (700 W), `matrix4_mb -6` on the sine input, a
# second at a time: -118.2, -140.7, -176.1, -199.9, -225.2 dBFS
MB_ONSET = (4.0, -90.0)
MB_COMPARE_SECONDS = 5
# matrix4 after a resampler forgets its start slowly: the steering axes are
# ratios of envelopes that start from zero, so over the resampler's
# pre-ringing at the stream's start the card's and the CPU's FFT rounding
# (~1e-16) is a difference in the envelopes' low digits, which the engine's
# slow EWMAs carry for seconds (tests/test_torch_matrix4.py shows the same
# between dsp_tpu and the port on the CPU). The run prints its difference a
# second; the first ONSET[0] s are held to ONSET[1], the rest to LIMIT_DBFS
ONSET = (5.0, -100.0)
# the roofline's rates: NVIDIA's H100 SXM data sheet, float64 and float32
# outside the tensor cores, and HBM3
F64_PEAK = 34e12
F32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
# the float32 mode (slices J1 and J2): the chains dsp-torch renders in
# float32, each held on the whole 300 s against the port's own float64 run
# of the same input on the card to BASELINE's -120 dBFS budget (dsp_tpu's
# float32 reaches -136.6 to -141.4 dBFS on these chains on the CPU)
F32_RUNS = ((FLAGSHIP, 2048), (FLAGSHIP, 1000), ("resample 48k", 2048))
F32_LIMIT_DBFS = -120.0
# slice J3's float32 upmixes: float32_no_sync and profile_chains run them
# beside F32_RUNS (float32_cli runs them too, with the FFT-convolution chains)
F32_UPMIXES = ((MATRIX4, 2048), (MATRIX4_MB, 2048))


class SmokeError(Exception):
    pass


def bound(nbytes, flops, peak=F64_PEAK):
    """The least time the card could take: bytes (each input read and each
    output written once) over the memory rate, or operations over the peak
    of their type (float64 unless given), whichever is larger. Returns (ms,
    what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def set_times(rec, ms, plain_ms, nbytes, flops, library_ms=None, peak=F64_PEAK):
    rec["ms"], rec["plain_ms"], rec["library_ms"] = ms, plain_ms, library_ms
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, peak)


def dbfs(err):
    return 20.0 * math.log10(err) if err > 0 else -math.inf


def check_close(what, err):
    print(f"  {what}: max |diff| {err:.3e} ({dbfs(err):.1f} dBFS)")
    if not dbfs(err) <= LIMIT_DBFS:
        raise SmokeError(f"{what}: {dbfs(err):.1f} dBFS is above {LIMIT_DBFS} dBFS")


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() on the current stream, after a
    warm-up, from CUDA events around `reps` calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps=20, tries=3):
    """(device milliseconds a call, kernels a call) of fn(): the time of the
    card's kernels as torch.profiler records them over `reps` calls after a
    warm-up, summed and divided by reps. A profile can come back with no
    event or miss a few, so it is taken up to `tries` times
    and the one that saw the most kernels counts; if none saw any, the time
    is a CUDA graph's replay of the same calls between CUDA events (no host
    enqueue in it) and the kernels a call are None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if len(times) > len(best):
            best = times
        if best and len(best) % reps == 0:
            break
    if best:
        return sum(best) / 1e3 / reps, len(best) / reps
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    torch.cuda.synchronize()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    print("  (torch.profiler saw no kernel: a CUDA graph's replay timed instead)")
    return start.elapsed_time(stop) / reps, None


def card_info():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        raise SmokeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def build_kernels():
    from dsp_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.load()
    wall = time.perf_counter() - t0
    print(f"kernels: built {kernels.build_dir().name} with nvcc in {wall:.2f} s")
    for line in kernels.LIBRARY.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def flagship_parts():
    """The flagship chain's fused-cascade plan, crossfeed lanes and the
    coupled form of its 30 Hz highpass, from the port's own chain build."""
    import numpy as np

    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.biquad import BiquadEffect
    from dsp_tpu_torch.effects.crossfeed import CrossfeedEffect
    from dsp_tpu_torch.ops import iir

    chain = build_chain_from_string(FLAGSHIP, StreamInfo(FS, CHANNELS))
    biquads = [e for e in chain.effects if type(e) is BiquadEffect]
    crossfeed = next(e for e in chain.effects if isinstance(e, CrossfeedEffect))
    plan = iir.CascadeBlockedPlan([e.c for e in biquads])
    hp = next(e for e in biquads if e.name == "highpass")
    A_cf, Bv_cf, c0_cf = iir.biquad_coeffs_to_ss(crossfeed.c)
    A_hp, Bv_hp = iir._coupled_form_ss(hp.c)
    return plan, {
        "crossfeed (companion, 4 lanes)": (A_cf, Bv_cf, c0_cf),
        "highpass 30 (coupled, 2 lanes)": (A_hp, Bv_hp, np.asarray(hp.c[0])),
    }


# cascades wider than the main path's, whose tables K1 cannot all stage in
# shared memory at B = 2048: at n = 80 it reads V and P from global memory,
# at n = 150 also the chunk powers (csrc/lti_blocked.cu stage_vp, stage_c)
WIDE_CASCADES = (40, 75)


def wide_plan(K):
    """The fused plan of K peaking filters, +-1.5 dB alternately, from 40 Hz
    to 16 kHz."""
    import numpy as np

    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.biquad import BiquadEffect
    from dsp_tpu_torch.ops import iir

    words = " ".join(f"eq {f:.1f} 1.0 {1.5 if i % 2 else -1.5}"
                     for i, f in enumerate(np.geomspace(40.0, 16000.0, K)))
    chain = build_chain_from_string(words, StreamInfo(FS, CHANNELS))
    return iir.CascadeBlockedPlan([e.c for e in chain.effects if type(e) is BiquadEffect])


def kernel_phases(records):
    import numpy as np
    import torch

    from dsp_tpu_torch.ops import iir

    dev = torch.device("cuda")
    rng = np.random.default_rng(20260)
    plan, scans = flagship_parts()
    k1 = records["lti_blocked"]
    k2 = records["biquad_scan"]

    print(f"K1 lti_blocked: flagship cascade, n = {plan.n}, C = {plan.C}, L = {plan.L}")
    for B in (2048, 65536):
        x = torch.as_tensor(rng.standard_normal((B, CHANNELS)) * 0.3, device=dev)
        st = torch.as_tensor(rng.standard_normal((2, CHANNELS, plan.n)) * 1e-2, device=dev)
        st[1] *= 1e-9  # a small lo part, as a state handed over from dsp_tpu may carry
        s_k, y_k = iir.lti_blocked(plan, st, x)
        s_r, y_r = iir.lti_blocked_ref(plan, st, x)
        torch.cuda.synchronize()
        err = max((y_k - y_r).abs().max().item(), (s_k - s_r).abs().max().item())
        check_close(f"B={B} kernel vs plain", err)
        _require(f"K1 B={B}: y and the end state {err:.3e} from the plain version, above "
                 f"{K1_ABS}", err <= K1_ABS)
        ms = cuda_ms(lambda: iir.lti_blocked(plan, st, x), 50)
        plain_ms = cuda_ms(lambda: iir.lti_blocked_ref(plan, st, x), 5)
        print(f"  B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        dev_ms = one_launch(f"K1 B={B}", lambda: iir.lti_blocked(plan, st, x))
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        if B == 2048:
            # x and y, the state in and out, the tables h, V, P, A^L, c0;
            # per chunk and channel the L-tap FIR, V·x, P·s and the carry
            n, C, L = plan.n, plan.C, plan.L
            nbytes = 8 * (2 * B * C + 4 * C * n + C * L + 2 * C * n * L + C * n * n + C)
            flops = 2 * C * (B // L) * (L * (L - 1) // 2 + 2 * n * L + n * n) + 2 * B * C
            set_times(k1, ms, plain_ms, nbytes, flops)
            k1["device_ms"] = dev_ms
    for K in WIDE_CASCADES:
        wide = wide_plan(K)
        x = torch.as_tensor(rng.standard_normal((2048, CHANNELS)) * 0.3, device=dev)
        st = torch.as_tensor(rng.standard_normal((2, CHANNELS, wide.n)) * 1e-2, device=dev)
        st[1] *= 1e-9
        s_k, y_k = iir.lti_blocked(wide, st, x)
        s_r, y_r = iir.lti_blocked_ref(wide, st, x)
        torch.cuda.synchronize()
        err = max((y_k - y_r).abs().max().item(), (s_k - s_r).abs().max().item())
        print(f"  a cascade of {K} biquads (n = {wide.n}), B=2048: {err:.3e} from the plain "
              f"version")
        _require(f"K1 {K} biquads: y and the end state {err:.3e} from the plain version, above "
                 f"{K1_ABS}", err <= K1_ABS)
        k1["max_abs_err"] = max(k1["max_abs_err"], err)

    print("K2 biquad_scan")
    for label, (A, Bv, c0) in scans.items():
        C = A.shape[0]
        A_t, Bv_t, c0_t = (torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in (A, Bv, c0))
        for B in (1, 7, 2048, 65536):
            x = torch.as_tensor(rng.standard_normal((B, C)) * 0.3, device=dev)
            st = torch.as_tensor(rng.standard_normal((C, 2)) * 1e-2, device=dev)
            s_k, y_k = iir.biquad_scan(A_t, Bv_t, c0_t, st, x)
            s_r, y_r = iir.biquad_scan_ref(A_t, Bv_t, c0_t, st, x)
            torch.cuda.synchronize()
            err = max((y_k - y_r).abs().max().item(), (s_k - s_r).abs().max().item())
            check_close(f"{label} B={B} kernel vs plain", err)
            k2["max_abs_err"] = max(k2["max_abs_err"], err)
            if B in (2048, 65536):
                ms = cuda_ms(lambda: iir.biquad_scan(A_t, Bv_t, c0_t, st, x), 50)
                plain_ms = cuda_ms(lambda: iir.biquad_scan_ref(A_t, Bv_t, c0_t, st, x), 5)
                print(f"  {label} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
                if B == 2048 and label.startswith("crossfeed"):
                    # x and y, A, Bv, c0, the state in and out; 10 operations
                    # a sample and lane, in a chain of B dependent steps
                    nbytes = 8 * (2 * B * C + 4 * C + 2 * C + C + 4 * C)
                    set_times(k2, ms, plain_ms, nbytes, 10 * B * C)


# K2's launches in the chain: (channels, crossfeed's two columns) for
# crossfeed_step, and the blocks each fused form is held at
CROSSFEED_LAYOUTS = ((2, (0, 1)), (4, (3, 1)))
FUSED_BLOCKS = (1, 7, 1000, 2048, 2560, 65536)


def k2_fused_phase(records):
    """K2 in the launches the chain makes with it, on the card: crossfeed's
    step (crossfeed_step, crossfeed_step_f32) on 2 channels and on 4 with
    the pair at columns 3 and 1, matrix4's band-limit pair
    (biquad_scan_series) and the per-sample biquad's (hi, lo) state
    (biquad_scan_pair), at every block of FUSED_BLOCKS. Each must equal,
    bit for bit, the launches it replaces on the card (the generic K2
    launch and the torch ops around it), and its plain version within
    -200 dBFS (float64) or one float32 ulp of its scale (float32). Times
    each at B = 2048 (the pair at B = 1000, the flagship's per-sample
    block) beside the composition it replaces, a call and device-only."""
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
    gains = (cf.direct_gain, cf.cross_gain)

    def normal(*shape, dtype=torch.float64, scale=0.3):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=dtype, device=dev)

    def hold(rec, what, got, composed, plain, f32):
        for k, c in zip(got, composed):
            _require(f"{what}: differs from the launches it replaces", torch_equal(k, c))
        if f32:
            for name, k, r in zip(("state", "y"), got, plain):
                _hold_f32(rec, f"{what} {name} against the plain version", k, r)
        else:
            err = max(_diff(k, r) for k, r in zip(got, plain))
            check_close(f"{what}: bit-equal to the launches it replaces; plain version", err)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)

    def time_pair(rec, what, new, old, plain, nbytes, flops, peak=F64_PEAK):
        ms, old_ms = cuda_ms(new, 50), cuda_ms(old, 50)
        (dev_ms, kern), (old_dev, old_kern) = device_ms(new), device_ms(old)
        plain_ms = cuda_ms(plain, 5)
        set_times(rec, ms, plain_ms, nbytes, flops, peak=peak)
        print(f"  {what}: {ms:.4f} ms a call, {dev_ms:.4f} ms device-only ({kern} kernels); "
              f"the launches it replaces {old_ms:.4f} ms, {old_dev:.4f} ms ({old_kern} kernels); "
              f"plain {plain_ms:.4f} ms; bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")

    print("K2 crossfeed_step (crossfeed's lanes and mix in one launch)")
    for dtype, sfx in ((torch.float64, ""), (torch.float32, "_f32")):
        rec = records[f"crossfeed_step{sfx}"]
        f32 = dtype == torch.float32
        A, Bv, c0 = (torch.as_tensor(getattr(cf, f"_ss{'32' if f32 else ''}_{k}"), device=dev)
                     for k in ("A", "Bv", "c0"))
        for C, cols in CROSSFEED_LAYOUTS:
            for B in FUSED_BLOCKS:
                x, st = normal(B, C, dtype=dtype), normal(4, 2, dtype=dtype, scale=1e-2)
                got = iir.crossfeed_step(A, Bv, c0, st, x, *cols, *gains)
                s_c, y = iir.biquad_scan(A, Bv, c0, st, iir.crossfeed_lanes(x, *cols))
                composed = (s_c, iir.crossfeed_mix(x, y, *cols, *gains))
                plain = iir.crossfeed_step_ref(A, Bv, c0, st, x, *cols, *gains)
                torch.cuda.synchronize()
                hold(rec, f"crossfeed_step{sfx} C={C} columns {cols} B={B}", got, composed, plain,
                     f32)
                if C == 2 and B == 2048:
                    def old():
                        s, y = iir.biquad_scan(A, Bv, c0, st, iir.crossfeed_lanes(x, *cols))
                        return s, iir.crossfeed_mix(x, y, *cols, *gains)
                    w = 4 if f32 else 8
                    # x in, out written, the lanes' A, Bv, c0 and state in and
                    # out; 10 operations a sample and lane, 5 a sample and
                    # column for the mix
                    time_pair(rec, f"crossfeed_step{sfx} B={B}",
                              lambda: iir.crossfeed_step(A, Bv, c0, st, x, *cols, *gains), old,
                              lambda: iir.crossfeed_step_ref(A, Bv, c0, st, x, *cols, *gains),
                              w * (2 * B * C + 4 * 4 + 4 * 2 + 4 + 4 * 4), (40 + 10) * B,
                              F32_PEAK if f32 else F64_PEAK)

    print("K2 biquad_scan_series (matrix4's band-limit pair in one launch)")
    rec = records["biquad_scan_series"]
    hp_args = [torch.as_tensor(getattr(m4e, k), device=dev) for k in ("A_hp", "B_hp", "c0_hp")]
    lp_args = [torch.as_tensor(getattr(m4e, k), device=dev) for k in ("A_lp", "B_lp", "c0_lp")]
    bl = [torch.as_tensor(getattr(m4e, k), device=dev) for k in ("A_bl", "B_bl", "c0_bl")]
    for B in FUSED_BLOCKS:
        x, st = normal(B, 2), normal(4, 2, scale=1e-2)

        def old():
            s1, y1 = iir.biquad_scan(*hp_args, st[:2], x)
            s2, y2 = iir.biquad_scan(*lp_args, st[2:], y1)
            return torch.cat([s1, s2]), y2
        got = iir.biquad_scan_series(*bl, st, x)
        composed, plain = old(), iir.biquad_scan_series_ref(*bl, st, x)
        torch.cuda.synchronize()
        hold(rec, f"biquad_scan_series B={B}", got, composed, plain, False)
        if B == 2048:
            # x in, y out, two stages' coefficients and states; 10
            # operations a sample, lane and stage
            time_pair(rec, f"biquad_scan_series B={B}", lambda: iir.biquad_scan_series(*bl, st, x),
                      old, lambda: iir.biquad_scan_series_ref(*bl, st, x),
                      8 * (2 * B * 2 + 4 * 4 + 4 * 2 + 4 + 4 * 4), 2 * 2 * 10 * B)

    print("K2 biquad_scan_pair (the per-sample biquad's (hi, lo) state in the kernel)")
    rec = records["biquad_scan_pair"]
    A, Bv, c0 = (torch.as_tensor(getattr(hp, k), device=dev) for k in ("_ss_A", "_ss_Bv", "_ss_c0"))
    for B in FUSED_BLOCKS:
        x, st = normal(B, 2), normal(2, 2, 2, scale=1e-2)
        st[1] *= 1e-9  # a small lo part, as a state handed over from dsp_tpu may carry

        def old():
            s_end, y = iir.biquad_scan(A, Bv, c0, st[0] + st[1], x)
            return torch.stack([s_end, torch.zeros_like(s_end)]), y
        got = iir.biquad_scan_pair(A, Bv, c0, st, x)
        composed, plain = old(), iir.biquad_scan_pair_ref(A, Bv, c0, st, x)
        torch.cuda.synchronize()
        hold(rec, f"biquad_scan_pair B={B}", got, composed, plain, False)
        if B == 1000:
            # x in, y out, A, Bv, c0, the (hi, lo) state in and out; 10
            # operations a sample and lane
            time_pair(rec, f"biquad_scan_pair B={B}", lambda: iir.biquad_scan_pair(A, Bv, c0, st, x),
                      old, lambda: iir.biquad_scan_pair_ref(A, Bv, c0, st, x),
                      8 * (2 * B * 2 + 4 * 2 + 2 * 2 + 2 + 2 * 8), 10 * B * 2)


# a run of per-sample biquads in one launch (iir.biquad_scan_run): its
# four forms (label, sample dtype, (hi, lo) states, lanes), the blocks and
# the run lengths it is held at
RUN_FORMS = (("f64 pair", "float64", True, 2), ("f64", "float64", False, 4),
             ("df", "float32", True, 2), ("df1", "float32", False, 4))
RUN_BLOCKS = (100, 1000, 1056, 2048, 65536)
RUN_STAGES = (2, 6)


def run_biquads(n, C):
    """The coupled form of n biquads of the flagship's kind (peaking
    filters, the 30 Hz highpass second), on C lanes: A [n, C, 2, 2], Bv
    [n, C, 2], c0 [n, C] float64, numpy."""
    import numpy as np

    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    words = " ".join("highpass 30 0.7071" if s == 1 else f"eq {40.0 * 3.1 ** s:.1f} 0.8 "
                     f"{3.0 if s % 2 else -2.0}" for s in range(n))
    effects = build_chain_from_string(words, StreamInfo(FS, C)).effects
    return tuple(np.stack([getattr(e, k) for e in effects]) for k in ("_ss_A", "_ss_Bv", "_ss_c0"))


def biquad_run_phase(records):
    """A run of n per-sample biquads in one launch (iir.biquad_scan_run and
    biquad_scan_run_df, csrc/biquad_scan.cu dsp_biquad_scan_run) in its four
    forms (RUN_FORMS), at every block of RUN_BLOCKS and run of RUN_STAGES:
    the (hi, lo) states as the chain keeps each biquad's [2, C, 2], the
    single ones as matrix4_mb keeps its inverse fshape ([C, n, 2], stage s
    at [:, s], written into views of a new tensor). Each call must be one
    launch by the library's count (kernels.biquad_run_launches), equal bit
    for bit to the n separate launches it replaces (biquad_scan,
    biquad_scan_pair or biquad_scan_df, a stage each on the one before's
    output), and within -200 dBFS (float64) or one float32 ulp of its scale
    (float32) of its plain version. Times six stages at B = 1000 (the
    flagship at -b 1000) a call and device-only beside the six launches,
    and matrix4_mb's two cascades' shape (two stages at B = 2048)."""
    import numpy as np
    import torch

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.ops import iir

    dev = torch.device("cuda")
    rng = np.random.default_rng(20314)
    print("K2 and K3 biquad_scan_run (a run of per-sample biquads in one launch)")
    for label, dtype, pair, C in RUN_FORMS:
        dt = getattr(torch, dtype)
        f32 = dt == torch.float32
        run = iir.biquad_scan_run_df if f32 else iir.biquad_scan_run
        rec = records[run.__name__]
        one = iir.biquad_scan_df if f32 else (iir.biquad_scan_pair if pair else iir.biquad_scan)
        for n in RUN_STAGES:
            A, Bv, c0 = (torch.as_tensor(a, device=dev) for a in run_biquads(n, C))
            for B in RUN_BLOCKS:
                x = torch.as_tensor(rng.standard_normal((B, C)) * 0.3, dtype=dt, device=dev)
                if pair:
                    raw = rng.standard_normal((n, 2, C, 2)) * 1e-2
                    raw[:, 1] *= 1e-9  # a small lo part, as dsp_tpu may hand over
                    states = [torch.as_tensor(r, dtype=dt, device=dev) for r in raw]
                    out = None
                else:
                    kept = torch.as_tensor(rng.standard_normal((C, n, 2)) * 1e-2, dtype=dt,
                                           device=dev)
                    states, out = kept.unbind(1), torch.empty_like(kept).unbind(1)

                def separate():
                    ends, xs = [], x
                    for s in range(n):
                        st, xs = one(A[s], Bv[s], c0[s], states[s].contiguous(), xs)
                        ends.append(st)
                    return ends, xs
                torch.cuda.synchronize()
                before = kernels.biquad_run_launches()
                ends, y = run(A, Bv, c0, states, x, out=out)
                torch.cuda.synchronize()
                launched = kernels.biquad_run_launches() - before
                want, y_sep = separate()
                ends_r, y_r = iir.biquad_scan_run_ref(A, Bv, c0, states, x)
                torch.cuda.synchronize()
                what = f"biquad_scan_run {label} n={n} B={B}"
                require_kernels(what, launched, 1)
                _require(f"{what}: differs from the {n} launches it replaces",
                         torch_equal(y, y_sep) and all(torch_equal(e, w) for e, w in zip(ends, want)))
                if f32:
                    _hold_f32(rec, f"{what} against the plain version", y, y_r)
                    for e, r in zip(ends, ends_r):
                        if pair:
                            _require(f"{what}: end state {_pair_rel(e, r):.2e} relative from "
                                     f"the plain version", _pair_rel(e, r) <= F32_STATE_REL)
                        else:
                            _hold_f32(rec, f"{what} end state", e, r)
                else:
                    err = max(_diff(y, y_r), *(_diff(e, r) for e, r in zip(ends, ends_r)))
                    check_close(f"{what}: one launch, bit-equal to the {n} launches; plain "
                                f"version", err)
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if (n, B, pair) == (6, 1000, True) or (n, B, pair) == (2, 2048, False):
                    ms, sep_ms = cuda_ms(lambda: run(A, Bv, c0, states, x, out=out), 50), \
                        cuda_ms(separate, 50)
                    (dev_ms, kern), (sep_dev, sep_kern) = device_ms(
                        lambda: run(A, Bv, c0, states, x, out=out)), device_ms(separate)
                    plain_ms = cuda_ms(lambda: iir.biquad_scan_run_ref(A, Bv, c0, states, x), 5)
                    w = 4 if f32 else 8
                    # x in, y out, the coefficients (7 float64 a stage and
                    # lane), the states in and out; 10 operations a sample,
                    # lane and stage
                    nbytes = w * 2 * B * C + 8 * 7 * n * C + w * 2 * 2 * n * C * (2 if pair else 1)
                    print(f"  {what}: {ms:.4f} ms a call, {dev_ms:.4f} ms device-only "
                          f"({kern} kernels); the {n} launches {sep_ms:.4f} ms, {sep_dev:.4f} ms "
                          f"({sep_kern} kernels); plain {plain_ms:.4f} ms")
                    rec.setdefault("times", []).append(
                        {"n": n, "B": B, "C": C, "pair": pair, "ms": ms, "device_ms": dev_ms,
                         "separate_ms": sep_ms, "separate_device_ms": sep_dev,
                         "plain_ms": plain_ms})
                    if pair:  # the record's row: the flagship's six at -b 1000
                        set_times(rec, ms, plain_ms, nbytes, 10 * B * C * n,
                                  peak=F64_PEAK)
                        rec["device_ms"] = dev_ms


def lean_wrapper_refusals():
    """The wrappers of fdl_mac, fdl_mac_f32, biquad_scan_run,
    biquad_scan_run_df, stats_step (both modes and dtypes) and levels_step
    on the card refuse every input their kernels do not take: another
    dtype, a tensor on another device, a shape that does not fit, a tensor
    that is not contiguous, an FDL not 16-byte aligned, and for a run,
    states of other strides in and out, or more stages than the kernel
    runs. Each must raise (TypeError or ValueError) and launch nothing."""
    import torch

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.ops import fft_conv as fc
    from dsp_tpu_torch.ops import iir

    dev = torch.device("cuda")
    c128, f64, f32 = torch.complex128, torch.float64, torch.float32
    K, NB, C = 4, 33, 2

    def misaligned(shape, dtype):  # a view one element past a 16-byte boundary
        n = math.prod(shape)
        return torch.zeros(n + 1, dtype=dtype, device=dev)[1:].view(shape)

    X = torch.zeros((NB, C), dtype=c128, device=dev)
    H = torch.zeros((K, NB, C), dtype=c128, device=dev)
    cases = []
    for fn, fdt in ((fc.fdl_mac, f64), (fc.fdl_mac_f32, f32)):
        fdl = torch.zeros((K, NB, C, 2), dtype=fdt, device=dev)
        other = f32 if fdt == f64 else f64
        cases += [(fn, f"{fn.__name__}: {what}", args) for what, args in (
            ("X complex64", (X.to(torch.complex64), H, fdl)),
            ("H complex64", (X, H.to(torch.complex64), fdl)),
            (f"the FDL {other}", (X, H, fdl.to(other))),
            ("H on the CPU", (X, H.cpu(), fdl)),
            ("the FDL on the CPU", (X, H, fdl.cpu())),
            ("H of other bins", (X, H[:, 1:].contiguous(), fdl)),
            ("the FDL of other slots", (X, H, fdl[1:].contiguous())),
            ("no FDL at K = 4", (X, H, None)),
            ("X not contiguous", (torch.zeros((C, NB), dtype=c128, device=dev).t(), H, fdl)),
            ("H not contiguous", (X, torch.zeros((K, C, NB), dtype=c128, device=dev)
                                  .transpose(1, 2), fdl)),
            ("the FDL not contiguous", (X, H, torch.zeros((K, NB, 2, C), dtype=fdt, device=dev)
                                        .transpose(2, 3))),
            ("the FDL misaligned", (X, H, misaligned((K, NB, C, 2), fdt))),
        )]
    A, Bv, c0 = (torch.as_tensor(a, device=dev) for a in run_biquads(2, C))
    for fn, dt in ((iir.biquad_scan_run, f64), (iir.biquad_scan_run_df, f32)):
        x = torch.zeros((1000, C), dtype=dt, device=dev)
        st = [torch.zeros((2, C, 2), dtype=dt, device=dev) for _ in range(2)]
        wide = torch.zeros((C, 2, 2), dtype=dt, device=dev)
        many = [torch.zeros((2, C, 2), dtype=dt, device=dev)] * 17
        A17, Bv17, c17 = (t[:1].expand(17, *t.shape[1:]).contiguous() for t in (A, Bv, c0))
        cases += [(fn, f"{fn.__name__}: {what}", args) for what, args in (
            ("a state of the other dtype", (A, Bv, c0, [st[0], st[1].to(f64 if dt == f32 else f32)],
                                            x)),
            ("float32 coefficients", (A.float(), Bv, c0, st, x)),
            ("a state on the CPU", (A, Bv, c0, [st[0], st[1].cpu()], x)),
            ("coefficients on the CPU", (A.cpu(), Bv, c0, st, x)),
            ("coefficients of 3 stages", (torch.cat([A, A[:1]]), Bv, c0, st, x)),
            ("states of another width", (A, Bv, c0, [s[:, :1] for s in st], x)),
            ("x not contiguous", (A, Bv, c0, st, torch.zeros((C, 1000), dtype=dt,
                                                            device=dev).t())),
            ("states of two layouts", (A, Bv, c0, [wide[:, 0], wide[:, 1].contiguous()], x)),
            ("17 stages", (A17, Bv17, c17, many, x)),
        )]
    cases += meter_refusals() + step_refusals()
    torch.cuda.synchronize()

    def lib_count():
        return (kernels.biquad_run_launches() + sum(kernels.meter_launches())
                + kernels.resample_launches() + kernels.noise_launches())

    for fn, what, args in cases:
        before, lib_before = fn.launches, lib_count()
        try:
            fn(*args)
        except (TypeError, ValueError) as e:
            _require(f"{what}: refused but counted a launch",
                     fn.launches == before and lib_count() == lib_before)
            print(f"  {what}: refused ({type(e).__name__})")
            continue
        raise SmokeError(f"{what}: the wrapper took it")
    print(f"lean wrappers: {len(cases)} bad inputs refused")


def meter_refusals():
    """(wrapper, what, args) of bad inputs to stats_step, stats_step_f32
    and levels_step on the card (lean_wrapper_refusals)."""
    import numpy as np
    import torch

    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.stats import StatsEffect
    from dsp_tpu_torch.ops import time_domain as td

    dev = torch.device("cuda")
    f64, f32 = torch.float64, torch.float32
    cases = []
    for fn, dt in ((td.stats_step, f64), (td.stats_step_f32, f32)):
        other = f32 if dt == f64 else f64
        x = torch.zeros((2048, CHANNELS), dtype=dt, device=dev)
        for interp in (False, True):
            e = StatsEffect("stats", StreamInfo(FS, CHANNELS), np.ones(CHANNELS, dtype=bool), None,
                            80, interp)
            st = {k: torch.as_tensor(v, device=dev) for k, v in e.state0().items()}
            st = {k: v.to(dt) if v.is_floating_point() else v for k, v in st.items()}
            table = torch.as_tensor(e._insert_table, dtype=dt, device=dev) if interp else None
            mode = "-i" if interp else "plain"
            bad = [("sum of the other dtype", "sum", st["sum"].to(other)),
                   ("peak_count int32", "peak_count", st["peak_count"].int()),
                   ("min on the CPU", "min", st["min"].cpu()),
                   ("max of another width", "max", st["max"][:1].contiguous()),
                   ("limit int32", "limit", st["limit"].int())]
            if interp:
                bad += [("m of 63 rows", "m", st["m"][1:].contiguous()),
                        ("z not contiguous", "z", torch.zeros((CHANNELS, 9), dtype=dt,
                                                              device=dev).t())]
            for what, k, v in bad:
                cases.append((fn, f"{fn.__name__} {mode}: {what}", ({**st, k: v}, x, table)))
            cases.append((fn, f"{fn.__name__} {mode}: xs not contiguous",
                          (st, torch.zeros((CHANNELS, 2048), dtype=dt, device=dev).t(), table)))
            cases.append((fn, f"{fn.__name__} {mode}: one stream's state for 3 streams",
                          (st, x.expand(3, -1, -1).contiguous(), table)))
        cases.append((fn, f"{fn.__name__} -i: a table of 66",
                      (st, x, torch.zeros(66, dtype=dt, device=dev))))
    lv = [torch.zeros(CHANNELS, dtype=f64, device=dev) for _ in range(3)]
    x = torch.zeros((2048, CHANNELS), dtype=f64, device=dev)
    g = 1e-3
    for what, args in (("avg float32", (lv[0].float(), lv[1], lv[2], x, g)),
                       ("peak on the CPU", (lv[0], lv[1].cpu(), lv[2], x, g)),
                       ("block_peak of 3", (lv[0], lv[1], torch.zeros(3, dtype=f64, device=dev),
                                            x, g)),
                       ("xs not contiguous", (*lv, torch.zeros((CHANNELS, 2048), dtype=f64,
                                                               device=dev).t(), g)),
                       ("xs of one dimension", (*lv, x[:, 0].contiguous(), g)),
                       ("one stream's meters for 3 streams",
                        (*lv, x.expand(3, -1, -1).contiguous(), g))):
        cases.append((td.levels_step, f"levels_step: {what}", args))
    return cases


def step_refusals():
    """(wrapper, what, args) of bad inputs to resample_step,
    resample_step_f32, irfft_ola, tpdf_noise and tpdf_noise_f32 on the card
    (lean_wrapper_refusals)."""
    import torch

    from dsp_tpu_torch.ops import resample_ops as ro
    from dsp_tpu_torch.ops import time_domain as td

    dev = torch.device("cuda")
    f64, f32 = torch.float64, torch.float32
    rs = ro.SpectralResampler(FS, 48000)
    cases = []
    for fn, dt in ((ro.resample_step, f64), (ro.resample_step_f32, f32)):
        x = torch.zeros((4 * rs.in_len, CHANNELS), dtype=dt, device=dev)
        ov = torch.zeros((rs.out_len, CHANNELS), dtype=dt, device=dev)
        # the float64 step converts an overlap of another dtype (resample_phase)
        other = ((("the overlap float64", (rs, ov.double(), x)),) if dt == f32 else ())
        for what, args in other + (
                ("the overlap on the CPU", (rs, ov.cpu(), x)),
                ("the overlap of 639 rows", (rs, ov[1:].contiguous(), x)),
                ("the overlap of 3 channels", (rs, torch.zeros((rs.out_len, 3), dtype=dt,
                                                               device=dev), x)),
                ("the overlap not contiguous", (rs, torch.zeros((CHANNELS, rs.out_len), dtype=dt,
                                                                device=dev).t(), x)),
                ("x not contiguous", (rs, ov, torch.zeros((CHANNELS, 4 * rs.in_len), dtype=dt,
                                                          device=dev).t())),
                ("x of 2351 frames", (rs, ov, x[1:].contiguous())),
                ("x of one dimension", (rs, ov, x[:, 0].contiguous()))):
            cases.append((fn, f"{fn.__name__}: {what}", args))
    Y = torch.zeros((rs.out_len + 1, 4 * CHANNELS), dtype=torch.complex128, device=dev)
    ov = torch.zeros((rs.out_len, CHANNELS), dtype=f64, device=dev)
    for what, args in (("Y complex64", (Y.to(torch.complex64), 2 * rs.out_len, ov, 1.0)),
                       ("the overlap float32", (Y, 2 * rs.out_len, ov.float(), 1.0)),
                       ("the overlap on the CPU", (Y, 2 * rs.out_len, ov.cpu(), 1.0)),
                       ("Y of other bins", (Y[1:].contiguous(), 2 * rs.out_len, ov, 1.0)),
                       ("the overlap of 3 channels", (Y, 2 * rs.out_len, torch.zeros(
                           (rs.out_len, 3), dtype=f64, device=dev), 1.0))):
        cases.append((ro.irfft_ola, f"irfft_ola: {what}", args))
    key = torch.zeros(2, dtype=torch.uint32, device=dev)
    sel = torch.tensor([True, False], device=dev)
    for fn, dt in ((td.tpdf_noise, f64), (td.tpdf_noise_f32, f32)):
        x = torch.zeros((2048, CHANNELS), dtype=dt, device=dev)
        for what, args in (("the key int32", (key.int(), x, 1e-3, sel)),
                           ("the key on the CPU", (key.cpu(), x, 1e-3, sel)),
                           ("a key of 3 words", (torch.zeros(3, dtype=torch.uint32, device=dev),
                                                 x, 1e-3)),
                           ("the selector uint8", (key, x, 1e-3, sel.to(torch.uint8))),
                           ("the selector of 3 channels", (key, x, 1e-3, torch.ones(
                               3, dtype=torch.bool, device=dev))),
                           ("the selector on the CPU", (key, x, 1e-3, sel.cpu())),
                           ("x not contiguous", (key, torch.zeros((CHANNELS, 2048), dtype=dt,
                                                                  device=dev).t(), 1e-3)),
                           ("x of one dimension", (key, x[:, 0].contiguous(), 1e-3)),
                           ("one key for 3 streams", (key, x.expand(3, -1, -1).contiguous(),
                                                      1e-3))):
            cases.append((fn, f"{fn.__name__}: {what}", args))
    return cases


# (K, NB) of each fdl_mac call on the main path, C = 2 throughout
FDL_MAC_SHAPES = (
    (1, 65537, "OLS: fir 64k at B=65536"),
    (32, 2049, "Upols: fir 64k at B=2048, and the Nupols head"),
    (15, 65537, "the Nupols tail: fir_p 1M at B=2048"),
    (16, 65537, "Upols: fir_p 1M at B=65536"),
    (1, 2049, "the reverse IIR at B=2048"),
)


def fdl_mac_phase(records):
    """fdl_mac and fdl_mac_f32 (a float32 FDL) against their plain versions
    on the card at the main path's shapes, seeded inputs and a nonzero FDL:
    Y held to LIMIT_DBFS (the sums run in another order), the shifted FDL
    equal (a copy, rounded to float32 in the float32 form); Y alone for the
    K = 1 form without a delay line, as OlsConv calls it. Times each shape a
    call (CUDA events) and device-only (device_ms), with the host path
    (their difference) and the rate of the bytes the call moves over the
    device-only time."""
    import numpy as np
    import torch

    from dsp_tpu_torch.ops.fft_conv import fdl_mac, fdl_mac_f32, fdl_mac_f32_ref, fdl_mac_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261)

    def cnormal(*shape):
        return torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                               device=dev)

    for fn, ref, dt in ((fdl_mac, fdl_mac_ref, torch.float64),
                        (fdl_mac_f32, fdl_mac_f32_ref, torch.float32)):
        name = fn.__name__
        rec = records[name]
        print(f"K5-K7 {name} (complex128, the FDL {dt})")
        rec["times"] = []
        for K, NB, what in FDL_MAC_SHAPES:
            X, H = cnormal(NB, CHANNELS), cnormal(K, NB, CHANNELS)
            fdl = torch.as_tensor(rng.standard_normal((K, NB, CHANNELS, 2)), dtype=dt, device=dev)
            y_k, f_k = fn(X, H, fdl)
            y_r, f_r = ref(X, H, fdl)
            torch.cuda.synchronize()
            _require(f"{name} K={K} NB={NB}: the shifted FDL differs from the plain version",
                     torch_equal(f_k, f_r))
            err = (y_k - y_r).abs().max().item()
            check_close(f"{name} K={K} NB={NB} ({what}) kernel vs plain, the shifted FDL equal",
                        err)
            if K == 1:
                y_k, _ = fn(X, H)
                y_r, _ = ref(X, H)
                torch.cuda.synchronize()
                e1 = (y_k - y_r).abs().max().item()
                check_close(f"{name} K={K} NB={NB} without a delay line, kernel vs plain", e1)
                err = max(err, e1)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            ms = cuda_ms(lambda: fn(X, H, fdl), 50)
            dev_ms, kern = device_ms(lambda: fn(X, H, fdl))
            plain_ms = cuda_ms(lambda: ref(X, H, fdl), 20)
            # the bytes the kernel moves: X, H, the K - 1 slots it reads, Y
            # and the K slots out
            w = 16 if dt == torch.float64 else 8
            moved = NB * CHANNELS * (16 * (K + 2) + w * (2 * K - 1))
            print(f"  {name} K={K} NB={NB}: {ms:.4f} ms a call, {dev_ms:.4f} ms device-only "
                  f"({kern} kernels; {moved / 1e6 / dev_ms:.0f} GB/s of {moved / 1e6:.1f} MB), "
                  f"host path {ms - dev_ms:.4f} ms; plain {plain_ms:.4f} ms")
            rec["times"].append({"K": K, "NB": NB, "ms": ms, "device_ms": dev_ms,
                                 "plain_ms": plain_ms, "gb_s": moved / 1e6 / dev_ms})
            if (K, NB) == (32, 2049) and dt == torch.float64:  # float32: float32_fft_phase
                # X, H and the FDL in; Y and the FDL out; a complex MAC is 8
                set_times(rec, ms, plain_ms, NB * CHANNELS * 16 * (3 * K + 2),
                          8 * K * NB * CHANNELS)
                rec["device_ms"] = dev_ms


# One FFT-convolution step of each engine on the main path, and one size
# of each other path of the transform's plan (ops/fft_conv.fft_plan):
# (label, C, N, La, Lx, lo, L, with_add, keep). rfft_pack transforms
# [a | x | 0] (a: La rows, x: Lx rows) at N and stores the last `keep` rows
# of [a | x] beside it (None: none; the engines' carried input); irfft_crop
# keeps rows [lo, lo + L) of the inverse, plus the Nupols tail's rows when
# with_add.
STEP_SHAPES = (
    ("OLS: fir 64k at B=65536", 2, 131072, 65535, 65536, 65535, 65536, False, 65535),
    ("Upols: fir 64k at B=2048", 2, 4096, 2048, 2048, 2048, 2048, False, 2048),
    ("the Nupols head: fir_p 1M at B=2048", 2, 4096, 2048, 2048, 2048, 2048, True, 2048),
    ("the Nupols tail, and Upols: fir_p 1M at B=65536", 2, 131072, 65536, 65536, 65536,
     65536, False, 65536),
    ("the reverse IIR of the crossover at B=2048", 4, 4096, 2048, 2048, 2048, 2048, False, 2048),
    ("one pass, not a power of two: the resampler's 44.1 kHz inner blocks", 8, 1176, 0, 588,
     0, 1176, False, None),
    ("one pass, 2·5·7^3: matrix4_mb's FIR by OLS at B=2048", 2, 3430, 1305, 2048, 1305, 2048,
     False, 1305),
    ("a prime radix above a block (a global pass): N = 2·8221", 2, 16442, 4000, 4000, 100,
     8000, True, 3000),
)
# The carried inputs: (label, C, La, Lx, L, lo, shift); see fft_conv.splice.
SPLICE_SHAPES = (
    ("OLS history: fir 64k at B=65536", 2, 65535, 65536, 65535, -1, 65536),
    ("Upols previous block at B=2048", 2, 2048, 2048, 2048, 0, 2048),
    ("Nupols stage write, block 17 of 32", 2, 65536, 2048, 65536, 17 * 2048, 0),
)


def timed_row(kern, plain, lib, reps=50):
    """A kernel, its plain version and its library call (or None) timed in
    turns two ways: per call (cuda_ms: back to back, so for a short call
    the host's enqueue) and device-only (device_ms: the kernels' own time).
    Returns the row's dict, with the kernels a call of each."""
    ms, plain_ms = cuda_ms(kern, reps), cuda_ms(plain, reps)
    lib_ms = None if lib is None else cuda_ms(lib, reps)
    dev, calls = device_ms(kern)
    lib_dev, lib_calls = (None, None) if lib is None else device_ms(lib)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "device_ms": dev,
            "kernels_a_call": calls, "library_device_ms": lib_dev,
            "library_kernels_a_call": lib_calls}


def fft_kernels(fn):
    """The kernels one call of fn launches through csrc/fft_conv.cu's
    transforms, by the library's own count (torch.profiler can miss a
    launch's events, or record none)."""
    from dsp_tpu_torch import kernels

    before = kernels.fft_launches()
    fn()
    return kernels.fft_launches() - before


def require_kernels(what, got, want):
    if got != want:
        raise SmokeError(f"{what}: {got} kernels launched a call, expected {want}")


# K1 (csrc/lti_blocked.cu) in float64 against its plain version: y and the
# end state, absolute; K11 (csrc/m4_env.cu) in both dtypes: the ticks and
# the carried envelopes (float32: hi + lo), absolute
K1_ABS = 1e-15
ENV_ABS = 4e-15


def one_launch(what, fn, reps=20):
    """Device-only ms of fn() (csrc/lti_blocked.cu or csrc/m4_env.cu) and a
    check that the call ran one kernel: by the library's own count of its
    launches over `reps` calls, and by torch.profiler's count of every
    kernel the card ran, the wrapper's included (a profile can miss an
    event of the `reps` calls: the count rounds; where CUPTI recorded no
    kernel in any try, the library's count stands alone)."""
    import torch

    from dsp_tpu_torch import kernels as lib

    torch.cuda.synchronize()
    before = lib.lookback_launches()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    launched = (lib.lookback_launches() - before) / reps
    ms, kernels = device_ms(fn, reps, tries=5)
    print(f"  {what}: device-only {ms:.4f} ms, {launched:g} launched a call by the library's "
          f"count, {'none recorded' if kernels is None else kernels} by torch.profiler")
    if launched != 1:
        raise SmokeError(f"{what}: {launched:g} kernels launched a call, expected 1")
    if kernels is not None and round(kernels) != 1:
        raise SmokeError(f"{what}: {kernels} kernels a call by torch.profiler, expected 1")
    return ms


def row_text(row):
    lib = ("" if row["library_ms"] is None else
           f"; library {row['library_ms']:.4f} ms a call, {row['library_device_ms']:.4f} ms "
           f"device-only ({row['library_kernels_a_call']} kernels)")
    return (f"kernel {row['ms']:.4f} ms a call, {row['device_ms']:.4f} ms device-only "
            f"({row['kernels_a_call']} kernels a call), plain {row['plain_ms']:.4f} ms{lib}")


def set_row(rec, row, nbytes, flops, peak=F64_PEAK):
    set_times(rec, row["ms"], row["plain_ms"], nbytes, flops, row["library_ms"], peak)
    rec["device_ms"], rec["library_device_ms"] = row["device_ms"], row["library_device_ms"]


def step_kernels_phase(records):
    """rfft_pack (with the engines' kept rows), irfft_crop and splice
    against their plain versions on the card at the main path's shapes and
    one shape of each other path of the plan, seeded audio-scale inputs;
    held to LIMIT_DBFS (the kept rows and splice exactly). A transform must
    run as its plan's passes: one kernel a call up to N = 8192, two at the
    four-step sizes (fft_kernels: the library's own count). Times each row
    both ways (timed_row)."""
    import numpy as np
    import torch

    from dsp_tpu_torch.ops import fft_conv as fc

    dev = torch.device("cuda")
    rng = np.random.default_rng(20262)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape) * 0.3, device=dev)

    print("K5-K7 rfft_pack and irfft_crop (float64, Stockham passes in shared memory)")
    for name in ("rfft_pack", "irfft_crop", "splice"):
        records[name]["times"] = []
    for what, C, N, La, Lx, lo, L, with_add, keep in STEP_SHAPES:
        plan = fc.fft_plan(N, C)
        print(f"  N={N} C={C}: {plan.path}, radices "
              f"{' | '.join(','.join(map(str, p.radices)) for p in plan.passes)}, "
              f"{plan.smem_bytes} bytes of shared memory a block")
        a, x = normal(La, C), normal(Lx, C)
        if keep is None:
            X_k = fc.rfft_pack(a, x, N)
        else:
            X_k, kept = fc.rfft_pack(a, x, N, keep=keep)
            want = fc.splice_ref(a, x, keep, keep - Lx, La + Lx - keep)
            torch.cuda.synchronize()
            if not torch.equal(kept, want):
                raise SmokeError(f"rfft_pack N={N} ({what}): the kept rows differ from splice_ref")
            print(f"  rfft_pack N={N}: the last {keep} rows of [a | x] kept, equal")
        X_r = fc.rfft_pack_ref(a, x, N).contiguous()
        add = normal(L, C) if with_add else None
        y_k, y_r = fc.irfft_crop(X_r, N, lo, L, add), fc.irfft_crop_ref(X_r, N, lo, L, add)
        torch.cuda.synchronize()
        for name, err in (("rfft_pack", (X_k - X_r).abs().max().item()),
                          ("irfft_crop", (y_k - y_r).abs().max().item())):
            check_close(f"{name} N={N} C={C} ({what}) kernel vs plain", err)
            rec = records[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        packed = torch.cat([a, x])
        timed = {
            # (kernel, plain version, the one torch call: rfft of the
            # packed [a | x | 0]; irfft then the slice)
            "rfft_pack": (lambda: fc.rfft_pack(a, x, N, keep=keep), lambda: fc.rfft_pack_ref(a, x, N),
                          lambda: torch.fft.rfft(packed, n=N, dim=0)),
            "irfft_crop": (lambda: fc.irfft_crop(X_r, N, lo, L, add),
                           lambda: fc.irfft_crop_ref(X_r, N, lo, L, add),
                           lambda: torch.fft.irfft(X_r, n=N, dim=0)[lo:lo + L]),
        }
        # a real FFT of N points is about 2.5·N·log2(N) operations a channel
        fft_flops = 2.5 * N * math.log2(N) * C
        io = {"rfft_pack": 8 * (La + Lx) * C + 16 * (N // 2 + 1) * C + 8 * (keep or 0) * C,
              "irfft_crop": 16 * (N // 2 + 1) * C + 8 * L * C * (2 if with_add else 1)}
        for name, (kern, plain, lib) in timed.items():
            row = timed_row(kern, plain, lib)
            launched = fft_kernels(kern)
            print(f"  {name} N={N} C={C}: {row_text(row)}; {launched} launched a call")
            require_kernels(f"{name} N={N} (its plan's passes)", launched, len(plan.passes))
            records[name]["times"].append({"N": N, "C": C, "keep": keep, "passes": len(plan.passes),
                                           **row})
            if (N, C, with_add) == (4096, 2, False):
                set_row(records[name], row, io[name], fft_flops)
    print("K5-K7 splice (float64; 16-byte copies of at most three row ranges)")
    rec = records["splice"]
    for what, C, La, Lx, L, lo, shift in SPLICE_SHAPES:
        a, x = normal(La, C), normal(Lx, C)
        o_k, o_r = fc.splice(a, x, L, lo, shift), fc.splice_ref(a, x, L, lo, shift)
        torch.cuda.synchronize()
        if not torch.equal(o_k, o_r):
            raise SmokeError(f"splice ({what}): kernel and plain version differ")
        # the one torch call: torch.cat of the same slices
        lo_c, hi_c = min(max(lo, 0), L), min(max(lo + x.shape[0], 0), L)
        parts = (a[shift:shift + lo_c], x[lo_c - lo:hi_c - lo], a[hi_c + shift:L + shift])
        row = timed_row(lambda: fc.splice(a, x, L, lo, shift),
                        lambda: fc.splice_ref(a, x, L, lo, shift), lambda: torch.cat(parts))
        print(f"  splice L={L} ({what}): equal; {row_text(row)}")
        rec["times"].append({"L": L, **row})
        if L == 2048:
            set_row(rec, row, 2 * 8 * L * C, 0)


def _to_cpu(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _diff(a, b):
    """max |a - b| over two tensors (compared on the host)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        return float((a - b).abs().max()) if a.numel() else 0.0
    return float((a.to(float) - b.to(float)).abs().max()) if a.numel() else 0.0


def _require(what, ok):
    if not ok:
        raise SmokeError(what)


def bits_equal(a, b):
    """Equal dtype, shape and bits: -0.0 and +0.0 differ."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.float64: torch.int64, torch.float32: torch.int32}.get(a.dtype)
    return torch.equal(a.view(view), b.view(view)) if view else torch.equal(a, b)


def td_signal(kind, n, rng):
    """[n, 2] of one stats -i input: quantized noise (the gate always
    open), "gate-sparse" (loud, -40 dB, loud, with edges off the 32-sample
    grid: the gate closes and reopens, also inside a window of the walk),
    silence, or one click a channel."""
    import numpy as np

    if kind == "noise":
        return np.round(rng.standard_normal((n, CHANNELS)) * 0.3 * 32768) / 32768
    if kind == "gate-sparse":
        g = np.ones(n)
        g[int(n * .2) + 5:int(n * .35) + 17] = 0.01
        g[int(n * .55) + 3:int(n * .7) + 29] = 0.01
        return rng.standard_normal((n, CHANNELS)) * 0.3 * g[:, None]
    x = np.zeros((n, CHANNELS))
    if kind == "click":
        x[n // 3 + 7, 0] = 0.9
        x[n // 3 + 40, 1] = -0.7
    return x


# stats -i beyond the main path's noise: (input, block, blocks carried)
STATS_CASES = (("gate-sparse", 2048, 2), ("silence", 2048, 1), ("click", 2048, 2),
               ("noise", 1000, 3), ("noise", 65536, 1))
# the shaped dither beyond the main path's: (block, blocks, error history)
# for every shape, and B = 65536 for lipshitz and wan9
DITHER_CASES = ((1000, 2, "zeros"), (2048, 1, "-0.0"))


def stats_interp_cases(rec, dtype, rng):
    """stats -i (stats_step or stats_step_f32) on STATS_CASES, the state
    carried across the blocks: every leaf bit-equal to the plain version's
    but the sums (another order: within 1e-12 relative, float32 one ulp of
    their scale)."""
    import numpy as np
    import torch

    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.stats import StatsEffect
    from dsp_tpu_torch.ops import time_domain as td

    dev = torch.device("cuda")
    f32 = dtype == torch.float32
    step = td.stats_step_f32 if f32 else td.stats_step
    for kind, B, blocks in STATS_CASES:
        e = StatsEffect("stats", StreamInfo(FS, CHANNELS), np.ones(CHANNELS, dtype=bool), None, 80,
                        True)
        table = torch.as_tensor(e._insert_table, dtype=dtype, device=dev)
        st = {k: torch.as_tensor(v, device=dev) for k, v in e.state0().items()}
        st = {k: v.to(dtype) if v.is_floating_point() else v for k, v in st.items()}
        sr = _to_cpu(st)
        x = torch.as_tensor(td_signal(kind, B * blocks, rng), dtype=dtype,
                            device=dev).reshape(blocks, B, CHANNELS)
        for blk in range(blocks):
            st = step(st, x[blk], table)
            sr = td.stats_step_ref(sr, x[blk].cpu(), table.cpu())
            torch.cuda.synchronize()
            what = f"{step.__name__} -i {kind} B={B} block {blk}"
            for k in st:
                if k not in ("sum", "sum_sq"):
                    _require(f"{what}: {k} differs from the plain version", bits_equal(st[k], sr[k]))
                elif f32:
                    ulps, err = _ulps(st[k], sr[k])
                    _require(f"{what}: {k} {ulps:.2f} ulp of its scale", ulps <= 1.0)
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                else:
                    d = _diff(st[k], sr[k])
                    _require(f"{what}: {k} {d:.3e}", d <= 1e-12 * max(1.0, float(sr[k].abs().max())))
                    rec["max_abs_err"] = max(rec["max_abs_err"], d)
        print(f"  -i {kind} B={B}: every leaf equal over {blocks} block(s)")


def dither_cases(dtype, rng):
    """The shaped dither (tpdf_dither or tpdf_dither_f32) in all six shapes
    on DITHER_CASES, and lipshitz and wan9 at B = 65536: key, ehist, nprev
    and y bit-equal to the plain version's."""
    import numpy as np
    import torch

    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.dither import DitherEffect
    from dsp_tpu_torch.ops import time_domain as td

    dev = torch.device("cuda")
    f32 = dtype == torch.float32
    fn, ref = (td.tpdf_dither_f32, td.tpdf_dither_f32_ref) if f32 else (td.tpdf_dither,
                                                                        td.tpdf_dither_ref)
    for shape in ("flat", "sloped", "sloped2", "lipshitz", "wan3", "wan9"):
        cases = DITHER_CASES + (((65536, 1, "noise"),) if shape in ("lipshitz", "wan9") else ())
        for B, blocks, hist in cases:
            e = DitherEffect("dither", StreamInfo(48000 if shape.startswith("wan") else FS,
                                                  CHANNELS),
                             np.ones(CHANNELS, dtype=bool), shape, 16.0, 16, False, False,
                             seed=4244)
            args = [torch.as_tensor(v, dtype=None if v.dtype == bool else dtype, device=dev)
                    for v in (e.n_mult, e.q_mult0, e.q_mult1, e.enabled, e.fir)]
            eh = {"zeros": np.zeros((9, CHANNELS)), "-0.0": np.full((9, CHANNELS), -0.0),
                  "noise": rng.standard_normal((9, CHANNELS)) * 1e-5}[hist]
            st = {"key": torch.as_tensor(e.state0()["key"], device=dev),
                  "ehist": torch.as_tensor(eh, dtype=dtype, device=dev),
                  "nprev": torch.as_tensor(rng.uniform(0, 0x7FFFFFFF, CHANNELS), dtype=dtype,
                                           device=dev)}
            for blk in range(blocks):
                xin = torch.as_tensor(rng.standard_normal((B, CHANNELS)) * 0.3, dtype=dtype,
                                      device=dev)
                ins = [st["key"], xin, st["ehist"], st["nprev"], *args]
                out_k = fn(*ins, e.mode)
                out_r = ref(*_to_cpu(ins), e.mode)
                torch.cuda.synchronize()
                for what, a, b in zip(("key", "ehist", "nprev", "y"), out_k, out_r):
                    _require(f"{fn.__name__} {shape} B={B} ehist {hist} block {blk}: {what} "
                             f"differs from the plain version", bits_equal(a, b))
                st = dict(zip(("key", "ehist", "nprev"), out_k[:3]))
        print(f"  {shape}: equal at " + ", ".join(f"B={B} ({hist})" for B, _, hist in cases))


# K16's plain mode and K17: the blocks each is checked at, and the limit
# (samples into the block) of a case that stops inside a tile of 256
METER_BLOCKS = (2048, 1000, 65536, 1)
METER_LIMIT = 700


def meter_cases(rec_plain, rec_levels, dtype, rng):
    """K16's plain mode (csrc/stats.cu's tiles) and K17 (csrc/levels.cu) in
    dtype at METER_BLOCKS and, at B = 2048, with a limit inside a tile, each
    over 2 blocks from a carried state, stereo: stats' decisions, min, max,
    peak and counts equal to the plain version's and its sums within 1e-12
    relative (float32: one ulp of their scale); levels within 1e-12 relative
    (float32: one ulp of their scale); each call made twice, bit-equal, and
    one launch by the library's count (kernels.meter_launches)."""
    import numpy as np
    import torch

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.stats import StatsEffect
    from dsp_tpu_torch.ops import time_domain as td

    dev = torch.device("cuda")
    f32 = dtype == torch.float32
    stats = td.stats_step_f32 if f32 else td.stats_step
    levels, levels_ref = ((td.levels_step_f32, td.levels_step_f32_ref) if f32 else
                          (td.levels_step, td.levels_step_ref))
    g = 1.0 - math.exp(-1.0 / (FS * 0.3))

    def close(what, rec, a, b, floor):
        """a within 1e-12 of max(floor, max |b|) (float32: one ulp of its
        scale)."""
        if f32:
            ulps, err = _ulps(a, b)
            _require(f"{what}: {ulps:.2f} ulp of its scale from the plain version", ulps <= 1.0)
        else:
            err = _diff(a, b)
            _require(f"{what}: {err:.3e} from the plain version",
                     err <= 1e-12 * max(floor, float(b.abs().max())))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)

    for B, limit in [(B, None) for B in METER_BLOCKS] + [(2048, METER_LIMIT)]:
        e = StatsEffect("stats", StreamInfo(FS, CHANNELS), np.ones(CHANNELS, dtype=bool), None,
                        80, False)
        st = {k: torch.as_tensor(v, device=dev) for k, v in e.state0().items()}
        st = {k: v.to(dtype) if v.is_floating_point() else v for k, v in st.items()}
        lv = [torch.as_tensor(rng.uniform(0, 0.1, CHANNELS), dtype=dtype, device=dev)
              for _ in range(3)]
        tag = f"B={B}" + ("" if limit is None else f", a limit {limit} into the block")
        for blk in range(2):
            x = torch.as_tensor(np.round(rng.standard_normal((B, CHANNELS)) * 0.3 * 32768) / 32768,
                                dtype=dtype, device=dev)
            if limit is not None and blk == 1:
                st["limit"] = torch.tensor(B + limit, device=dev)
            lib = kernels.meter_launches()
            out, again = stats(st, x), stats(st, x)
            lv_out, lv_again = levels(*lv, x, g), levels(*lv, x, g)
            now = kernels.meter_launches()
            what = f"{stats.__name__} plain {tag} block {blk}"
            _require(f"{what}: {now[0] - lib[0]} kernels for 2 calls by the library's count, "
                     f"expected 2", now[0] - lib[0] == 2)
            _require(f"{levels.__name__} {tag}: {now[1] - lib[1]} kernels for 2 calls by the "
                     f"library's count, expected 2", now[1] - lib[1] == 2)
            ref = td.stats_step_ref(_to_cpu(st), x.cpu())
            lv_ref = levels_ref(*_to_cpu(lv), x.cpu(), g)
            torch.cuda.synchronize()
            for k in ref:
                _require(f"{what}: {k} differs between two calls", bits_equal(out[k], again[k]))
                if k in ("sum", "sum_sq"):
                    close(f"{what}: {k}", rec_plain, out[k], ref[k], 1.0)
                else:
                    _require(f"{what}: {k} differs from the plain version", bits_equal(out[k], ref[k]))
            for name, a, a2, b in zip(("avg", "peak", "block_peak"), lv_out, lv_again, lv_ref):
                _require(f"{levels.__name__} {tag}: {name} differs between two calls",
                         bits_equal(a, a2))
                close(f"{levels.__name__} {tag} block {blk}: {name}", rec_levels, a, b, 0.0)
            st, lv = out, list(lv_out)
    print(f"  {stats.__name__} plain and {levels.__name__} at B = "
          f"{', '.join(map(str, METER_BLOCKS))} and with a limit inside a tile: stats' decisions "
          f"equal, sums and meters within {'one ulp' if f32 else '1e-12 relative'}, two calls "
          f"bit-equal, one launch a call")


# K14's checks: (quality, -M, depth in samples, modulator bandwidth in Hz);
# a 1 kHz modulator reads about 10 knot rows a tile and a 5 kHz one about
# 30 (its phase t0 + step·n reaches 464 in a block), and a 0.2 s depth
# (17,640 samples) is a line window too long to stage in shared memory
MOD_DELAY_CASES = tuple((qual, mono, 0.5e-3 * FS, 1.0) for qual in (0, 1, 2)
                        for mono in (False, True)) + ((2, False, 0.5e-3 * FS, 1000.0),
                                                      (2, False, 0.5e-3 * FS, 5000.0),
                                                      (1, True, 0.2 * FS, 1.0))
# the float64 read against its plain version, at every modulator: the two
# write the same operations in the same order, each rounded where written
# (the phase's product and sum twice, the FMAs dsp_tpu's XLA:CPU takes
# once), so nvcc contracts nothing the plain version does not; a fast
# modulator's phase, which reaches the hundreds, then moves no read
MOD_DELAY_DBFS = -280.0
# the blocks each case steps through: longer than the line, then shorter
MOD_DELAY_BLOCKS = (2048, 2048, 64)


def mod_delay_step(e, st, x, wrapper):
    """ModDelayEffect.step on the card, required to run as one launch of
    csrc/mod_delay.cu (by the library's own count and the wrapper's) and
    no splice: (state', y)."""
    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.ops import fft_conv

    lib, own = kernels.mod_delay_launches(), wrapper.launches
    spl = fft_conv.splice.launches + fft_conv.splice_f32.launches
    out = e.step(st, x)
    launched = kernels.mod_delay_launches() - lib
    _require(f"{wrapper.__name__} step: {launched} kernels launched by the library's count "
             f"({wrapper.launches - own} by the wrapper's), expected 1",
             launched == 1 and wrapper.launches - own == 1)
    _require(f"{wrapper.__name__} step: a splice was launched",
             fft_conv.splice.launches + fft_conv.splice_f32.launches == spl)
    return out


NOISE_BLOCKS = (2048, 1000, 65536, 1)


def noise_cases(rec, dtype, rng):
    """K18 (tpdf_noise, or tpdf_noise_f32) at each of NOISE_BLOCKS, stereo,
    with every channel and with the first only, over 2 blocks carried
    through the key, and through NoiseEffect.step (the selector it caches):
    each call one launch by the library's count (kernels.noise_launches) and
    the wrapper's, key' and y bit-equal to the plain version's on a host
    copy. Times a call at B = 2048 and its plain version (CUDA events) and
    its device-only time (torch.profiler)."""
    import numpy as np
    import torch

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.core.prng import prng_key
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.noise import NoiseEffect
    from dsp_tpu_torch.ops import time_domain as td

    dev = torch.device("cuda")
    f32 = dtype == torch.float32
    entry = td.tpdf_noise_f32 if f32 else td.tpdf_noise
    ref = td.tpdf_noise_f32_ref if f32 else td.tpdf_noise_ref
    mult = 1e-3 / 0x7FFFFFFF
    part = NoiseEffect("noise", StreamInfo(FS, CHANNELS), np.array([True, False]), mult)
    first = torch.tensor([True, False], device=dev)
    for B in NOISE_BLOCKS:
        for how in ("every channel", "the first channel", "NoiseEffect.step"):
            sel = {"every channel": None, "the first channel": first}.get(how)
            key = prng_key(987654 + B).to(dev)
            for blk in range(2):
                x = torch.as_tensor(rng.standard_normal((B, CHANNELS)) * 0.3, dtype=dtype,
                                    device=dev)
                torch.cuda.synchronize()
                lib0, w0 = kernels.noise_launches(), entry.launches
                if how == "NoiseEffect.step":
                    k_k, y_k = part.step(key, x)
                    want = ref(key.cpu(), x.cpu(), mult, first.cpu())
                else:
                    k_k, y_k = entry(key, x, mult, sel)
                    want = ref(key.cpu(), x.cpu(), mult, None if sel is None else sel.cpu())
                torch.cuda.synchronize()
                launched = (kernels.noise_launches() - lib0, entry.launches - w0)
                what = f"{entry.__name__} B={B} {how} block {blk}"
                _require(f"{what}: {launched} launches (library, wrapper), expected one",
                         launched == (1, 1))
                _require(f"{what}: key' or y differs from the plain version",
                         bits_equal(k_k, want[0]) and bits_equal(y_k, want[1]))
                key = k_k
    B = 2048
    x = torch.as_tensor(rng.standard_normal((B, CHANNELS)) * 0.3, dtype=dtype, device=dev)
    ms = cuda_ms(lambda: entry(key, x, 1e-3), 50)
    plain_ms = cuda_ms(lambda: ref(key, x, 1e-3), 10)
    dev_ms, calls = device_ms(lambda: entry(key, x, 1e-3))
    es = x.element_size()
    # x in, y out, the keys; 3 operations a sample of the sample type (the
    # threefry integer rounds, ~200 a sample, are not counted)
    set_times(rec, ms, plain_ms, 2 * es * B * CHANNELS + 16, 3 * B * CHANNELS,
              peak=F32_PEAK if f32 else F64_PEAK)
    rec["device_ms"] = dev_ms
    print(f"  B = {', '.join(map(str, NOISE_BLOCKS))}, with and without a channel selection "
          f"and through NoiseEffect.step: one launch a call, key' and y bit-equal to the plain "
          f"version; B=2048: kernel {ms:.4f} ms a call, {dev_ms:.4f} ms device-only ({calls} "
          f"kernels a call), plain {plain_ms:.4f} ms")


def time_domain_phase(records):
    """Slice C's kernels against their plain versions at the main path's
    shape (B = 2048, stereo): the plain version runs on a host copy of the
    same inputs, which the CPU tests hold to dsp_tpu. Noise, dither, the
    stats decisions and the -i estimator's state must come out equal; the
    stats sums and the levels meters within 1e-12 relative (sums in another
    order); the modulated read within -280 dBFS. Times kernel and plain
    version on the card."""
    import numpy as np
    import torch

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.core.prng import prng_key
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.delay import ModDelayEffect
    from dsp_tpu_torch.effects.dither import DitherEffect
    from dsp_tpu_torch.effects.stats import StatsEffect
    from dsp_tpu_torch.ops import time_domain as td

    dev = torch.device("cuda")
    rng = np.random.default_rng(20264)
    B, C = 2048, CHANNELS
    f64 = torch.float64
    x = torch.as_tensor(rng.standard_normal((B, C)) * 0.3, device=dev)
    x_c = x.cpu()
    key = prng_key(987654).to(dev)

    print("K18-noise tpdf_noise (threefry, stereo)")
    noise_cases(records["tpdf_noise"], f64, rng)

    print("K15 tpdf_dither (all six shapes at 16 bits, B=2048, stereo; lipshitz at B=65536)")
    rec = records["tpdf_dither"]
    for shape in ("flat", "sloped", "sloped2", "lipshitz", "wan3", "wan9"):
        for blocks in ((B,) if shape != "lipshitz" else (B, 65536)):
            e = DitherEffect("dither", StreamInfo(FS, C), np.ones(C, dtype=bool), shape, 16.0, 16,
                             False, False, seed=4242)
            xin = torch.as_tensor(rng.standard_normal((blocks, C)) * 0.3, device=dev)
            args = [torch.as_tensor(v, device=dev) for v in (
                e.n_mult, e.q_mult0, e.q_mult1, e.enabled, e.fir)]
            st = {k: torch.as_tensor(v, device=dev) for k, v in e.state0().items()}
            st["ehist"] = torch.as_tensor(rng.standard_normal((9, C)) * 1e-5, device=dev)
            st["nprev"] = torch.as_tensor(rng.uniform(0, 0x7FFFFFFF, C), device=dev)

            def run_k():
                return td.tpdf_dither(st["key"], xin, st["ehist"], st["nprev"], *args, e.mode)

            out_k = run_k()
            out_r = td.tpdf_dither_ref(*_to_cpu([st["key"], xin, st["ehist"], st["nprev"], *args]),
                                       e.mode)
            torch.cuda.synchronize()
            for what, a, b in zip(("key", "ehist", "nprev", "y"), out_k, out_r):
                _require(f"tpdf_dither {shape} B={blocks}: {what} differs from the plain version",
                         torch.equal(a.cpu(), b.cpu()))
            if shape == "lipshitz" and blocks == B:
                ms = cuda_ms(run_k, 50)
                plain_ms = cuda_ms(lambda: td.tpdf_dither_ref(
                    st["key"], xin, st["ehist"], st["nprev"], *args, e.mode), 2)
                # x in, y out, the states; 2 operations a sample for the
                # noise, 23 for the 9-tap feedback quantizer; each channel
                # is a chain of B dependent steps
                set_times(rec, ms, plain_ms, 16 * B * C + 8 * C * 22 + 16, 25 * B * C)
                print(f"  lipshitz B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                      f"(a chain of {B} samples a channel)")
        print(f"  {shape}: key, ehist, nprev and y equal")
    dither_cases(f64, rng)

    print("K16 stats_step (B=2048, stereo, quantized input; 3 blocks, a limit in the third)")
    rec = records["stats_step"]
    rec["times"] = []
    q = torch.as_tensor(np.round(rng.standard_normal((3, B, C)) * 0.3 * 32768) / 32768, device=dev)
    for interp in (False, True):
        e = StatsEffect("stats", StreamInfo(FS, C), np.ones(C, dtype=bool), None, 80, interp)
        table = torch.as_tensor(e._insert_table, device=dev) if interp else None
        st = {k: torch.as_tensor(v, device=dev) for k, v in e.state0().items()}
        sr = _to_cpu(st)
        for blk in range(3):
            if blk == 2:
                st["limit"] = torch.tensor(2 * B + 1000, device=dev)
                sr["limit"] = st["limit"].cpu()
            lib = kernels.meter_launches()[0]
            st = td.stats_step(st, q[blk], table)
            _require(f"stats_step {'-i' if interp else 'plain'}: not one launch by the library's "
                     f"count", kernels.meter_launches()[0] - lib == 1)
            sr = td.stats_step_ref(sr, q[blk].cpu(), None if table is None else table.cpu())
            torch.cuda.synchronize()
            for k in st:
                d = _diff(st[k], sr[k])
                if k in ("sum", "sum_sq"):
                    ok = d <= 1e-12 * max(1.0, float(sr[k].abs().max()))
                    rec["max_abs_err"] = max(rec["max_abs_err"], d)
                else:
                    ok = bits_equal(st[k], sr[k])
                _require(f"stats_step {'-i' if interp else 'plain'} block {blk}: {k} differs "
                         f"({d:.3e})", ok)
        s0 = {k: torch.as_tensor(v, device=dev) for k, v in e.state0().items()}
        ms = cuda_ms(lambda: td.stats_step(s0, q[0], table), 50)
        plain_ms = cuda_ms(lambda: td.stats_step_ref(s0, q[0], table), 2)  # sets gated_samples
        state_bytes = 8 * (5 * C * 2 + 2 * C * 2 + 2) + (8 * C * 2 * 81 + 67 * 8 if interp else 0)
        # the accumulators, 4 operations a sample; -i, a gated sample
        # (counted on this input) adds 134 for the buffer and direct taps
        # and 4 fits of about 12; each channel is a chain of B steps
        flops = 4 * B * C + (182 * td.stats_step_ref.gated_samples if interp else 0)
        label = "-i" if interp else "plain"
        print(f"  {label}: decisions and state equal over 3 blocks; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        rec["times"].append({"mode": label, "ms": ms, "plain_ms": plain_ms})
        if interp:
            set_times(rec, ms, plain_ms, 8 * B * C + state_bytes, flops)
        else:
            prec = records["stats_step_plain"]
            set_times(prec, ms, plain_ms, 8 * B * C + state_bytes, flops)
            prec["device_ms"] = device_ms(lambda: td.stats_step(s0, q[0]))[0]
            print(f"  plain: {prec['device_ms']:.4f} ms device-only")
    stats_interp_cases(rec, f64, rng)
    meter_cases(records["stats_step_plain"], records["levels_step"], f64, rng)

    print("K17 levels_step (B=2048, stereo)")
    rec = records["levels_step"]
    g = 1.0 - math.exp(-1.0 / (FS * 0.3))
    st = [torch.as_tensor(rng.uniform(0, 0.1, C), device=dev) for _ in range(3)]
    out_k = td.levels_step(*st, x, g)
    out_r = td.levels_step_ref(*_to_cpu(st), x_c, g)
    for a, b in zip(out_k, out_r):
        d = _diff(a, b) / float(b.abs().max())
        _require(f"levels_step: {d:.3e} relative to the plain version", d <= 1e-12)
        rec["max_abs_err"] = max(rec["max_abs_err"], _diff(a, b))
    ms = cuda_ms(lambda: td.levels_step(*st, x, g), 50)
    plain_ms = cuda_ms(lambda: td.levels_step_ref(*st, x, g), 10)
    set_times(rec, ms, plain_ms, 8 * B * C + 48 * C, 6 * B * C)
    rec["device_ms"] = device_ms(lambda: td.levels_step(*st, x, g))[0]
    print(f"  within 1e-12 relative; kernel {ms:.4f} ms, {rec['device_ms']:.4f} ms device-only, "
          f"plain {plain_ms:.4f} ms")

    print("K14 mod_delay (0.5 ms depth, q0/q1/q2, -m and -M, blocks of 2048, 2048 and 64, "
          "stereo; 1 kHz and 5 kHz modulators; a 0.2 s depth read through L1)")
    rec = records["mod_delay"]
    for qual, mono, samples, fc in MOD_DELAY_CASES:
        limit = 10.0 ** (MOD_DELAY_DBFS / 20.0)
        e = ModDelayEffect("delay", StreamInfo(FS, C), np.ones(C, dtype=bool), samples, fc, mono,
                           qual, seed=31337)
        st = {k: torch.as_tensor(v, device=dev) for k, v in e.state0().items()}
        table = None if e.table is None else torch.as_tensor(e.table, device=dev)
        sel = torch.ones(C, dtype=torch.bool, device=dev)
        what = f"mod_delay q{qual} {'-M' if mono else '-m'} depth {e.depth:g} fc {fc:g}"
        for blk, Bk in enumerate(MOD_DELAY_BLOCKS):
            xin = torch.as_tensor(rng.standard_normal((Bk, C)) * 0.3, device=dev)
            args = (st["key"], st["y"], st["t"], st["buf"], xin, sel, table)
            out_k = mod_delay_step(e, st, xin, td.mod_delay)
            k_k, y_k, t_k, o_k, b_k = (out_k[0]["key"], out_k[0]["y"], out_k[0]["t"], out_k[1],
                                       out_k[0]["buf"])
            k_r, y_r, t_r, o_r, b_r = td.mod_delay_ref(*_to_cpu(args), e.depth, e.step_size,
                                                       e.n_taps, qual)
            torch.cuda.synchronize()
            err = max(_diff(o_k, o_r), _diff(y_k, y_r), _diff(t_k, t_r))
            _require(f"{what} block {blk}: key differs", torch.equal(k_k.cpu(), k_r))
            _require(f"{what} block {blk}: the carried line differs from the plain version's",
                     torch.equal(b_k.cpu(), b_r))
            _require(f"{what} block {blk}: {dbfs(err):.1f} dBFS (limit {dbfs(limit):.0f})",
                     err <= limit)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if fc != 1.0:
                print(f"  {what} block {blk}: {dbfs(err):.1f} dBFS from the plain version")
            st = out_k[0]
        if (qual, mono, fc) == (2, True, 1.0):
            xin = torch.as_tensor(rng.standard_normal((B, C)) * 0.3, device=dev)
            H = e.len + e.n_taps
            run = (lambda: td.mod_delay(st["key"], st["y"], st["t"], st["buf"], xin, sel,
                                        table, e.depth, e.step_size, e.n_taps, qual))
            ms = cuda_ms(run, 50)
            plain_ms = cuda_ms(lambda: td.mod_delay_ref(
                st["key"], st["y"], st["t"], st["buf"], xin, sel, table, e.depth,
                e.step_size, e.n_taps, qual), 10)
            # x and the line in, y and the line out, the table; the B-spline
            # (~20), 4 x 32 multiply-adds and the join (~15) a sample
            nbytes = 8 * (2 * B * C + 2 * H * C + table.numel()) + 80
            set_times(rec, ms, plain_ms, nbytes, (20 + 8 * e.n_taps + 15) * B * C)
            rec["device_ms"] = device_ms(run)[0]
            print(f"  q2 -M B={B}: kernel {ms:.4f} ms a call, {rec['device_ms']:.4f} ms "
                  f"device-only, plain {plain_ms:.4f} ms")
    print(f"  every modulator's within {dbfs(rec['max_abs_err']):.1f} dBFS; keys and carried "
          f"lines equal; one launch a step")


# the resampler's rate pairs (in_fs, out_fs) and inner blocks a step
# (n = 1; 4: -b 2048 at 44.1 kHz; 112: -b 65536) of resample_phase
RESAMPLE_PAIRS = ((44100, 48000), (44100, 192000), (48000, 44100), (44100, 88200),
                  (96000, 44100))
RESAMPLE_INNER = (1, 4, 112)
RESAMPLE_DBFS = -280.0  # the float64 step against its plain version on the host


def parent_step(rs, overlap, x):
    """The resampler's step as it ran before its one-launch kernel, composed
    on the card from the wrappers kept for the route of three launches:
    float64 rfft_pack, resample_fold, irfft_crop, then the scale and the
    shifted add as torch ops; float32 rfft_pack_f32, resample_fold and
    irfft_ola_f32."""
    import torch

    from dsp_tpu_torch.ops.fft_conv import irfft_crop, rfft_pack, rfft_pack_f32
    from dsp_tpu_torch.ops.resample_ops import irfft_ola_f32, resample_fold

    n, C = x.shape[0] // rs.in_len, x.shape[1]
    ratio = rs.out_len / rs.in_len
    if x.dtype == torch.float32:
        X = rfft_pack_f32(x, 2 * rs.in_len, blocks=n)
        return irfft_ola_f32(resample_fold(X, rs.fold), 2 * rs.out_len, overlap, ratio)
    X = rfft_pack(x[:0], x, 2 * rs.in_len, blocks=n)
    y2 = irfft_crop(resample_fold(X, rs.fold), 2 * rs.out_len, 0, 2 * rs.out_len) * ratio
    head, tail = y2.reshape(2, rs.out_len, n, C)
    prev = torch.cat([overlap[:, None], tail[:, :-1]], dim=1)
    return tail[:, -1].contiguous(), (head + prev).permute(1, 0, 2).reshape(n * rs.out_len, C)


def resample_phase(records):
    """K8, the resampler's step (csrc/resample.cu), in both dtypes: at each
    of RESAMPLE_PAIRS and RESAMPLE_INNER inner blocks, stereo, one launch a
    step by the library's count and the wrapper's; y and the overlap
    bit-equal to parent_step's on the card, and to the plain step on a host
    copy within RESAMPLE_DBFS (float32: one float32 ulp of the scale, the
    float32 rounding of float64 values that differ in their last bits). Then
    resample 44101 (a global pass of the prime 44,101 in its inverse) on the
    route of three launches: rfft_pack, resample_fold and irfft_ola one
    each (their float32 forms), the transforms' passes and the overlap-add
    by the library's count and nothing else by torch.profiler's, against the
    parent route bit for bit and the plain step as above. On both routes the
    float64 step given a float32 overlap equals the step given that overlap
    in float64, bit for bit. resample_fold alone
    against its plain version (within 1e-15 relative: the same products in
    the same order). Times the step, its plain version, the fold and
    irfft_ola."""
    import numpy as np
    import torch

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.ops import fft_conv as fc
    from dsp_tpu_torch.ops import resample_ops as ro

    dev = torch.device("cuda")
    rng = np.random.default_rng(20265)
    limit = 10.0 ** (RESAMPLE_DBFS / 20.0)

    def inputs(rs, n, dt):
        x = torch.as_tensor(rng.standard_normal((n * rs.in_len, CHANNELS)) * 0.3, dtype=dt,
                            device=dev)
        ov = torch.as_tensor(rng.standard_normal((rs.out_len, CHANNELS)) * 0.1, dtype=dt,
                             device=dev)
        return ov, x

    def hold_plain(rec, what, got, want, limit=limit):
        if got[1].dtype == torch.float32:
            for k, name in enumerate(("overlap", "y")):
                _hold_f32(rec, f"{what} {name}", got[k], want[k])
            return None
        err = max(_diff(got[0], want[0]), _diff(got[1], want[1]))
        _require(f"{what}: {dbfs(err):.1f} dBFS from the plain step (limit "
                 f"{dbfs(limit):.0f})", err <= limit)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        return err

    def overlap_as_float64(rs, what):
        # the float64 step converts a float32 overlap before its route
        ov, x = inputs(rs, 1, torch.float64)
        ov32 = ov.float()
        got, want = rs.block(ov32, x), rs.block(ov32.double(), x)
        _require(f"{what}: a float32 overlap gives other bits than its float64 value",
                 all(bits_equal(a, b) and a.dtype == torch.float64 for a, b in zip(got, want)))
        print(f"  {what}: a float32 overlap taken as its float64 value")

    def step_io(rs, n, dt):  # bytes once and float64 operations of a step
        es, ncol = torch.tensor([], dtype=dt).element_size(), n * CHANNELS
        Nf, Ni, T = 2 * rs.in_len, 2 * rs.out_len, len(rs.tab_l)
        tables = 4 * (rs.out_len + 2) + 24 * T + 20 * (Nf + Ni)
        nbytes = es * CHANNELS * (n * rs.in_len + rs.out_len * (n + 2)) + tables
        flops = (2.5 * (Nf * math.log2(Nf) + Ni * math.log2(Ni)) + 8 * T + 3 * rs.out_len) * ncol
        return nbytes, flops

    for dt, entry, ref in ((torch.float64, ro.resample_step, ro.resample_step_ref),
                           (torch.float32, ro.resample_step_f32, ro.resample_step_f32_ref)):
        rec = records[entry.__name__]
        print(f"K8 {entry.__name__} (one launch; {', '.join(map(str, RESAMPLE_INNER))} inner "
              f"blocks, stereo)")
        for pair in RESAMPLE_PAIRS:
            rs = ro.SpectralResampler(*pair)
            _require(f"resample {pair}: route {rs.route}", rs.route == ro.ONE_LAUNCH)
            for n in RESAMPLE_INNER:
                ov, x = inputs(rs, n, dt)
                torch.cuda.synchronize()
                lib0, w0 = kernels.resample_launches(), entry.launches
                got = rs.block(ov, x)
                torch.cuda.synchronize()
                launched = (kernels.resample_launches() - lib0, entry.launches - w0)
                _require(f"{entry.__name__} {pair} n={n}: {launched} launches (library, "
                         f"wrapper), expected one", launched == (1, 1))
                parent = parent_step(rs, ov, x)
                for k, name in enumerate(("overlap", "y")):
                    _require(f"{entry.__name__} {pair} n={n}: {name} differs from the parent "
                             f"route's", bits_equal(got[k], parent[k]))
                hold_plain(rec, f"{entry.__name__} {pair} n={n}", got,
                           ref(rs, ov.cpu(), x.cpu()))
            print(f"  {pair[0]} -> {pair[1]} (in_len {rs.in_len}, out_len {rs.out_len}): "
                  f"one launch a step, bit-equal to the parent route at n = "
                  f"{', '.join(map(str, RESAMPLE_INNER))}")
        rs = ro.SpectralResampler(FS, 48000)
        if dt == torch.float64:
            overlap_as_float64(rs, "resample_step 48 kHz")
        for n in (4, 112):
            ov, x = inputs(rs, n, dt)
            reps = 50 if n == 4 else 10
            ms = cuda_ms(lambda: rs.block(ov, x), reps)
            plain_ms = cuda_ms(lambda: ref(rs, ov, x), 10)
            parent_ms = cuda_ms(lambda: parent_step(rs, ov, x), reps)
            dev_ms, calls = device_ms(lambda: rs.block(ov, x), min(reps, 20))
            parent_dev, parent_calls = device_ms(lambda: parent_step(rs, ov, x), min(reps, 20))
            print(f"  48 kHz n={n}: step {ms:.4f} ms a call, {dev_ms:.4f} ms device-only "
                  f"({calls} kernels a call); the parent route "
                  f"{parent_ms:.4f} ms a call, {parent_dev:.4f} ms device-only ({parent_calls} "
                  f"kernels); plain {plain_ms:.4f} ms")
            rec.setdefault("times", []).append(
                {"n": n, "ms": ms, "device_ms": dev_ms, "parent_ms": parent_ms,
                 "parent_device_ms": parent_dev, "plain_ms": plain_ms})
            if n == 4:
                set_times(rec, ms, plain_ms, *step_io(rs, n, dt))
                rec["device_ms"] = dev_ms

    print("K8's route of three launches: resample 44101 (inverse N = 88,202, a global pass of "
          "44,101), one inner block, stereo")
    rs = ro.SpectralResampler(FS, 44101)
    _require(f"resample 44101: route {rs.route}", rs.route == ro.THREE_LAUNCHES)
    passes = sum(len(fc.fft_plan(N, 1).passes) for N in (2 * rs.in_len, 2 * rs.out_len))
    for dt, entry, ref, ola in ((torch.float64, ro.resample_step, ro.resample_step_ref,
                                 ro.irfft_ola),
                                (torch.float32, ro.resample_step_f32, ro.resample_step_f32_ref,
                                 ro.irfft_ola_f32)):
        pack = fc.rfft_pack_f32 if dt == torch.float32 else fc.rfft_pack
        ov, x = inputs(rs, 1, dt)
        wrappers = (pack, ro.resample_fold, ola, entry)
        torch.cuda.synchronize()
        before = [w.launches for w in wrappers] + [kernels.resample_launches(),
                                                   kernels.fft_launches()]
        got = rs.block(ov, x)
        torch.cuda.synchronize()
        after = [w.launches for w in wrappers] + [kernels.resample_launches(),
                                                  kernels.fft_launches()]
        delta = [a - b for a, b in zip(after, before)]
        _require(f"resample 44101 {dt}: launches (pack, fold, ola, step, one-launch kernel, "
                 f"transform kernels) {delta}, expected {[1, 1, 1, 0, 0, passes + 1]}",
                 delta == [1, 1, 1, 0, 0, passes + 1])
        dev_ms, calls = device_ms(lambda: rs.block(ov, x), 3)
        _require(f"resample 44101 {dt}: {calls} kernels a step by torch.profiler, expected "
                 f"{passes + 2} (the passes, the overlap-add and the fold; no torch op)",
                 calls is None or round(calls) == passes + 2)
        parent = parent_step(rs, ov, x)
        for k, name in enumerate(("overlap", "y")):
            _require(f"resample 44101 {dt}: {name} differs from the parent route's",
                     bits_equal(got[k], parent[k]))
        # the direct sum of 44,101 terms rounds more than a block pass: the
        # earlier slices' limit
        err = hold_plain(records[entry.__name__], f"resample 44101 {dt}", got,
                         ref(rs, ov.cpu(), x.cpu()), 10.0 ** (LIMIT_DBFS / 20.0))
        print(f"  {dt}: rfft_pack, resample_fold, {ola.__name__}: {passes + 1} transform kernels "
              f"and the fold, {dev_ms:.4f} ms device-only ({calls} kernels by torch.profiler); "
              f"bit-equal to the parent route"
              + ("" if err is None else f"; {dbfs(err):.1f} dBFS from the plain step"))
        if dt == torch.float64:
            overlap_as_float64(rs, "resample_step 44101")
            Y = ro.resample_fold(fc.rfft_pack(x[:0], x, 2 * rs.in_len), rs.fold)
            Ni, ratio = 2 * rs.out_len, rs.out_len / rs.in_len
            row = timed_row(lambda: ro.irfft_ola(Y, Ni, ov, ratio),
                            lambda: ro.irfft_ola_ref(Y, Ni, ov, ratio),
                            lambda: torch.fft.irfft(Y, n=Ni, dim=0), reps=3)
            o_k, o_r = ro.irfft_ola(Y, Ni, ov, ratio), ro.irfft_ola_ref(Y.cpu(), Ni, ov.cpu(),
                                                                        ratio)
            err = max(_diff(o_k[0], o_r[0]), _diff(o_k[1], o_r[1]))
            check_close("irfft_ola at N = 88,202 against its plain version", err)
            records["irfft_ola"]["max_abs_err"] = err
            print(f"  irfft_ola N=88202 C=2: {row_text(row)}")
            # Y in, y and both overlaps, the twiddle and position tables; the
            # function's work, not the direct pass's: an inverse real FFT of
            # Ni points a channel (~2.5·Ni·log2(Ni) operations), the scale
            # and the add
            set_row(records["irfft_ola"], row,
                    16 * (rs.out_len + 1) * CHANNELS + 8 * rs.out_len * 3 * CHANNELS + 20 * Ni,
                    (2.5 * Ni * math.log2(Ni) + 3 * rs.out_len) * CHANNELS)

    print("K8 resample_fold (complex128; 4 inner blocks of 588 frames, stereo)")
    rec = records["resample_fold"]
    for out_fs in (48000, 192000):
        rs = ro.SpectralResampler(FS, out_fs)
        ncol = 4 * CHANNELS
        X = torch.as_tensor(rng.standard_normal((rs.in_len + 1, ncol))
                            + 1j * rng.standard_normal((rs.in_len + 1, ncol)), device=dev)
        Y_k = ro.resample_fold(X, rs.fold)
        Y_r = ro.resample_fold_ref(X.cpu(), rs.fold)
        torch.cuda.synchronize()
        err = _diff(torch.view_as_real(Y_k), torch.view_as_real(Y_r))
        _require(f"resample_fold {out_fs}: {err:.3e} against the plain version",
                 err <= 1e-15 * float(Y_r.abs().max()))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        ms = cuda_ms(lambda: ro.resample_fold(X, rs.fold), 50)
        plain_ms = cuda_ms(lambda: ro.resample_fold_ref(X, rs.fold), 10)
        T = len(rs.tab_l)
        print(f"  {FS} -> {out_fs}: {T} entries into {rs.out_len + 1} bins, "
              f"{'equal' if err == 0 else f'within {err:.3e}'}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms a call")
        if out_fs == 48000:
            # X in and Y out, the tables (ptr, j, flags, s) once; a complex
            # product and sum (8 operations) an entry and column
            nbytes = 16 * ncol * (rs.in_len + 1 + rs.out_len + 1) + 4 * (rs.out_len + 2) + 24 * T
            set_times(rec, ms, plain_ms, nbytes, 8 * T * ncol)


def transient_signal(seconds, fs=FS, seed=5):
    """Program material with transients, so that matrix4's events sample,
    hold and release: a quiet stereo bed (two tones and noise) and decaying
    noise bursts, one every 0.15-0.45 s, each panned left, right, centre,
    to the rear (the channels in antiphase) or between."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    t = np.arange(n) / fs
    x = 0.02 * np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)], 1)
    x += 0.005 * rng.standard_normal((n, 2))
    pans = np.array([[1.0, 0.05], [0.05, 1.0], [0.7, 0.7], [0.7, -0.7], [1.0, 0.5], [-0.3, 1.0]])
    pos = int(0.1 * fs)
    while pos < n:
        m = min(n - pos, int(0.3 * fs))
        burst = rng.standard_normal(m) * np.exp(-np.arange(m) / (0.04 * fs)) * 0.3
        x[pos:pos + m] += burst[:, None] * pans[rng.integers(len(pans))]
        pos += int(rng.uniform(0.15, 0.45) * fs)
    return x


# the matrix4 kernel checks: (options, rate, block); the fifth is the block
# that follows `resample 48k` at -b 2048 (2352 in, 2560 out: Nc = 80); the
# last one block of -b 65536 (Nc = 2048: the engine's chunks wrap many times)
M4_KERNEL_CASES = (
    ("matrix4 -6", FS, 2048),
    ("matrix4 matrix=v1 -6", FS, 2048),
    ("matrix4 direct_path -6", FS, 2048),
    ("matrix4 phase_flip=false,shelf=none,lowpass=none -6", FS, 2048),
    ("matrix4 -6", 48000, 2560),
    ("matrix4 -6", FS, 65536),
)
# the serial event engines, whose records carry their microseconds a tick
ENGINES = ("m4_event", "m4_event_f32", "m4mb_event", "m4mb_event_f32")


def check_blocks(B, fs):
    """(seconds of transient input, blocks held to the plain version) of a
    kernel check at block B: 3 blocks after 2 s of warm-up, or 1 block of
    65536 after one, or 1 block above 192 kHz."""
    blocks = 1 if B > 8192 or fs > 192000 else 3
    return max(2.5, (blocks + 1) * B / fs + 0.01), blocks


def set_tick_us(rec, Nc, ms):
    """An event engine's microseconds a tick, from `ms` a call of Nc ticks,
    kept in its record (us_a_tick: {"Nc=64": .., "Nc=2048": ..}): the
    checks' timing at B = 2048 and one call at the B = 65536 case."""
    rec.setdefault("us_a_tick", {})[f"Nc={Nc}"] = ms * 1e3 / Nc


def engine_tick_line(records):
    """One line: each event engine's microseconds a tick on this card."""
    print("event engines, us a tick a call: " + "; ".join(
        f"{name} {Nc} {us:.3f}" for name in ENGINES
        for Nc, us in records[name].get("us_a_tick", {}).items()))
M4_DECISIONS = ("ord_count", "diff_count", "early_count", "ignore_count")


def _rel(a, b):
    """max |a - b| over max(1, max |b|), compared on the host."""
    b = b.cpu()
    return _diff(a, b) / max(1.0, float(b.abs().max()) if b.numel() else 0.0)


def matrix4_phase(records):
    """K11 m4_env, K9 + K10 m4_event and K12 + K13 m4_audio against their
    plain versions on the card, on the same inputs, over 3 blocks of
    transient material after 2 s of it through the kernels, for each case
    of M4_KERNEL_CASES. The event state's bool and integer leaves must be
    equal (the decisions); its floats, the coefficient sets and the
    interpolator window within 1e-12 relative (the plain version runs the
    same operations through torch's CUDA ops); the envelopes within 1e-12
    relative (a scan of another grouping); the audio within -280 dBFS. The
    event counters of each case are printed. Times the three kernels and
    their plain versions at B = 2048 (v4)."""
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    limit = 10.0 ** (-280.0 / 20.0)
    print("K9-K13 matrix4: m4_env, m4_event, m4_audio (3 blocks after 2 s of transients)")
    for words, fs, B in M4_KERNEL_CASES:
        cc = CompiledChain(build_chain_from_string(words, StreamInfo(fs, CHANNELS)), B,
                           device="cuda")
        e = cc._runtime_effects[0]
        seconds, blocks = check_blocks(B, fs)
        x = torch.as_tensor(transient_signal(seconds, fs), device="cuda")
        warm = x.shape[0] // B - blocks
        cc.run_blocks(x[: warm * B].reshape(warm, B, CHANNELS))
        errs = {"m4_env": 0.0, "m4_event": 0.0, "m4_audio": 0.0}
        env_abs = 0.0
        for blk in range(warm, warm + blocks):
            st = cc.states[0]
            xb = x[blk * B:(blk + 1) * B].contiguous()
            args = [e.device_array(k, xb) for k in ("A_bl", "B_bl", "c0_bl")]
            _, y_bp = iir.biquad_scan_series(*args, st["bp_m"], xb)
            env_k = m4.m4_env(y_bp, st["env_m"], e.g_env)
            env_r = m4.m4_env_ref(y_bp, st["env_m"], e.g_env)
            errs["m4_env"] = max(errs["m4_env"], *(_rel(a, b) for a, b in zip(env_k, env_r)))
            env_abs = max(env_abs, *(_diff(a, b) for a, b in zip(env_k, env_r)))
            fade_p, disable = int(st["fade_p"]), bool(st["disable"])
            ev1 = {k: v[None] for k, v in st["ev"].items()}
            ins = (ev1, st["bg_cs"][None], env_k[1][None], st["interp_y"][None], fade_p, disable)
            out_k = m4.m4_event(e.ctl, *ins)
            out_r = m4.m4_event_ref(e.ctl, *ins)
            torch.cuda.synchronize()
            for k, kind in m4.EV_LEAVES:
                a, b = out_k[0][k], out_r[0][k]
                if kind != "f":
                    _require(f"m4_event {words} at {fs} block {blk}: {k} differs from the plain "
                             f"version", torch.equal(a, b))
                else:
                    errs["m4_event"] = max(errs["m4_event"], _rel(a, b))
            for a, b in zip(out_k[1:], out_r[1:]):
                errs["m4_event"] = max(errs["m4_event"], _rel(a, b))
            ics = out_k[2][0]
            a_ins = (e.audio, xb, st["buf"], st["interp_c"], ics, st["shelf_m"], st["lp_m"],
                     st["pf_m"])
            y_k, y_r = m4.m4_audio(*a_ins), m4.m4_audio_ref(*a_ins)
            errs["m4_audio"] = max(errs["m4_audio"], *(_diff(a, b) for a, b in zip(y_k, y_r)))
            cc.run_blocks(xb[None])
        ev = cc.states[0]["ev"]
        counters = {k: int(ev[k]) for k in M4_DECISIONS}
        print(f"  {words} at {fs} Hz, B={B}: decisions equal; floats within "
              f"{errs['m4_event']:.3e}, envelopes {errs['m4_env']:.3e} relative, audio "
              f"{dbfs(errs['m4_audio']):.1f} dBFS; after {int(ev['t'])} ticks {counters}")
        _require(f"matrix4 {words}: no event in the check's input", counters["diff_count"]
                 + counters["ord_count"] > 0)
        print(f"  m4_env {words} at {fs} Hz, B={B}: ticks and envelopes within {env_abs:.3e} "
              f"absolute (limit {ENV_ABS})")
        _require(f"m4_env {words}: {errs['m4_env']:.3e} relative", errs["m4_env"] <= 1e-12)
        _require(f"m4_env {words}: {env_abs:.3e} absolute", env_abs <= ENV_ABS)
        _require(f"m4_event {words}: {errs['m4_event']:.3e} relative", errs["m4_event"] <= 1e-12)
        _require(f"m4_audio {words}: {dbfs(errs['m4_audio']):.1f} dBFS", errs["m4_audio"] <= limit)
        errs["m4_env"] = env_abs
        for name, err in errs.items():
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        if B in (2048, 65536) and fs == FS and words == "matrix4 -6":
            dev_ms = one_launch(f"m4_env B={B}", lambda: m4.m4_env(y_bp, st["env_m"], e.g_env))
            if B == 2048:
                records["m4_env"]["device_ms"] = dev_ms
        if B == 65536:
            set_tick_us(records["m4_event"], B // 32, cuda_ms(lambda: m4.m4_event(e.ctl, *ins), 3))
            dev_ms, _ = device_ms(lambda: m4.m4_audio(*a_ins), 5)
            print(f"  m4_audio B={B}: kernel {cuda_ms(lambda: m4.m4_audio(*a_ins), 5):.4f} ms, "
                  f"device-only {dev_ms:.4f} ms")
        if (words, fs, B) != M4_KERNEL_CASES[0]:
            continue
        Nc, L, n_in, n_out = B // 32, e.ctl.p["buf_len"], CHANNELS, e.audio.n_out
        st = cc.states[0]
        ev1 = {k: v[None] for k, v in st["ev"].items()}
        ins = (ev1, st["bg_cs"][None], env_k[1][None], st["interp_y"][None], 0, False)
        a_ins = (e.audio, xb, st["buf"], st["interp_c"], ics, st["shelf_m"], st["lp_m"],
                 st["pf_m"])
        timed = {
            # the pair in, the envelopes in and out, the ticks out; the
            # input (|.| or a square) and the EWMA's two operations a
            # sample and envelope
            "m4_env": (lambda: m4.m4_env(y_bp, st["env_m"], e.g_env),
                       lambda: m4.m4_env_ref(y_bp, st["env_m"], e.g_env),
                       16 * B + 128 + 64 * Nc, 8 * 3 * B),
            # the state in and out (about 70 values and 10 rings of L), the
            # ticks in, the coefficient sets, window and display out; about
            # 300 operations a tick for the engine, 250 for the epilogue and
            # 112 for the insert
            "m4_event": (lambda: m4.m4_event(e.ctl, *ins), lambda: m4.m4_event_ref(e.ctl, *ins),
                         2 * 8 * (80 + 10 * L) + 64 * Nc + 8 * Nc * (48 + 4) + 2 * 512,
                         (300 + 250 + 112) * Nc),
            # x in and y out, the line, the coefficient sets, the states;
            # per sample 10 interpolated values (4 operations each), the
            # matrix (12), two shelves (4 x 8 each) and two allpasses (5)
            "m4_audio": (lambda: m4.m4_audio(*a_ins), lambda: m4.m4_audio_ref(*a_ins),
                         8 * (B * (n_in + n_out) + 2 * e.len + 48 * (Nc + 1) + 32),
                         (40 + 12 + 64 + 10) * B),
        }
        for name, (kern, plain, nbytes, flops) in timed.items():
            ms = cuda_ms(kern, 20)
            plain_ms = cuda_ms(plain, 2)
            set_times(records[name], ms, plain_ms, nbytes, flops)
            print(f"  {name} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        print(f"  m4_audio B={B}: device-only {device_ms(timed['m4_audio'][0])[0]:.4f} ms")
        set_tick_us(records["m4_event"], Nc, records["m4_event"]["ms"])


def matrix4_no_sync():
    """One matrix4 step does not synchronise: run_blocks over 16 blocks at
    B = 2048 of input already on the card, the status line off, under
    torch.cuda.set_sync_debug_mode("error")."""
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_args
    from dsp_tpu_torch.core.types import StreamInfo

    cc = CompiledChain(build_chain_from_args(["matrix4", "-6"], StreamInfo(FS, CHANNELS)), 2048,
                       device="cuda")
    xs = torch.as_tensor(transient_signal(1.0)[: 20 * 2048], device="cuda").reshape(20, 2048,
                                                                                 CHANNELS)
    cc.run_blocks(xs[:4])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = cc.run_blocks(xs[4:])
    except RuntimeError as e:
        raise SmokeError(f"the matrix4 step synchronised: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _require("the matrix4 run without syncs gave non-finite output", bool(torch.isfinite(ys).all()))
    print(f"matrix4 step: 16 blocks ran with no host sync, t = {int(cc.states[0]['ev']['t'])}")


# matrix4_mb at the rates where its 13 bands' rings leave shared memory for
# a device scratch (from 461.9 kHz), and just below: one block each
HIGH_RATE_MB = tuple(("matrix4_mb -6", fs, 2048) for fs in (441000, 470400, 768000))
# the matrix4_mb kernel checks: (options, rate, block). 1056 = 33 x 32 takes
# the bank's L = 1 plan; at 192 kHz the 13 bands' rings need 93.6 KB of
# shared memory
MB_KERNEL_CASES = (
    ("matrix4_mb -6", FS, 2048),
    ("matrix4_mb matrix=v1 -6", FS, 2048),
    ("matrix4_mb direct_path -6", FS, 2048),
    ("matrix4_mb filter_type=butterworth,freq_mask=0.5 -6", FS, 2048),
    ("matrix4_mb -6", 48000, 2048),
    ("matrix4_mb -6", FS, 1056),
    ("matrix4_mb -6", 192000, 8192),
    ("matrix4_mb -6", FS, 65536),
    *HIGH_RATE_MB,
)
# the audio path against its plain version: the allpass scans group
# another way, the band sums are the same order
MB_AUDIO_DBFS = -290.0


def mb_effect(words, fs, B, dtype=None):
    """A matrix4_mb chain on the card at block B (float64 unless dtype is
    given): (its Matrix4MbEffect, that effect's state)."""
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.matrix4_mb import Matrix4MbEffect

    cc = CompiledChain(build_chain_from_string(words, StreamInfo(fs, CHANNELS)), B, dtype=dtype,
                       device="cuda")
    i = next(i for i, e in enumerate(cc._runtime_effects) if isinstance(e, Matrix4MbEffect))
    return cc._runtime_effects[i], cc.states[i]


def mb_audio_launches(rec, wrapper, plain, cfg, ins, B, close):
    """m4mb_audio (or its float32 form) with the phase flip and without it
    (the same block's inputs): one launch a call by the library's count
    (and torch.profiler's, where it records), the output `close` to the
    plain version's. Keeps the device-only ms of the flip at B = 2048."""
    from dsp_tpu_torch.ops import m4_engine as m4

    for flip in (True, False):
        c = cfg if flip else m4.M4MbAudio(cfg.len, False, cfg.direct_path)
        got, want = wrapper(c, *ins), plain(c, *ins)
        _require(f"{wrapper.__name__} B={B} phase_flip={flip}: differs from the plain version",
                 all(close(a, b) for a, b in zip(got, want)))
        dev_ms = one_launch(f"{wrapper.__name__} B={B} phase_flip={flip}",
                            lambda: wrapper(c, *ins))
        if flip and B == 2048:
            rec["device_ms"] = dev_ms


def matrix4_mb_phase(records):
    """matrix4_mb's kernels against their plain versions on the card, on the
    same inputs, over 3 blocks of transient material after 2 s of it
    through the effect, for each case of MB_KERNEL_CASES: K1 on the 13-band
    bank (26 lanes, 40 states; L = 128, or L = 1), K11 m4mb_env (13 lanes,
    with the frequency-mask mix where asked), K9 + K10 m4mb_event and
    K12 + K13 m4mb_audio. The bank and the envelopes within -290 dBFS and
    1e-13 relative; the engines' decisions and their thresholds equal; the
    engines' other floats and the coefficient sets within 1e-13 relative;
    the audio within MB_AUDIO_DBFS. Times the kernels and their plain
    versions at B = 2048 (v4), and the bank at L = 1."""
    import torch

    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    print("K1, K9-K13 matrix4_mb: the bank, m4mb_env, m4mb_event, m4mb_audio "
          "(3 blocks after 2 s of transients)")
    for words, fs, B in MB_KERNEL_CASES:
        e, st = mb_effect(words, fs, B)
        seconds, blocks = check_blocks(B, fs)
        x = torch.as_tensor(transient_signal(seconds, fs), device="cuda")
        warm = x.shape[0] // B - blocks
        for blk in range(warm):
            st, _ = e.step(st, x[blk * B:(blk + 1) * B].contiguous())
        errs = {"bank": 0.0, "m4mb_env": 0.0, "m4mb_event": 0.0, "m4mb_audio": 0.0}
        env_abs = 0.0
        plan = e._bank_plan(B)
        for blk in range(warm, warm + blocks):
            xb = x[blk * B:(blk + 1) * B].contiguous()
            _, s_pre = e._cascade("fsh", st["fshape_m"].reshape(2, 2, 2), e._pair.take(xb).contiguous())
            xt = s_pre.repeat(1, m4.N_BANDS)
            bank_k = iir.lti_blocked(plan, st["bank"]["fused"], xt)
            bank_r = iir.lti_blocked_ref(plan, st["bank"]["fused"], xt)
            errs["bank"] = max(errs["bank"], *(_diff(a, b) for a, b in zip(bank_k, bank_r)))
            bands = bank_k[1].view(B, m4.N_BANDS, 2)
            w = None if e.fmw is None else e.device_array("fmw", xb)
            env_k = m4.m4mb_env(bands, st["env_m"], e.g_env, w)
            env_r = m4.m4mb_env_ref(bands, st["env_m"], e.g_env, w)
            errs["m4mb_env"] = max(errs["m4mb_env"], *(_rel(a, b) for a, b in zip(env_k, env_r)))
            env_abs = max(env_abs, *(_diff(a, b) for a, b in zip(env_k, env_r)))
            ins = (e.ctl, st["ev"], st["ev_thresh"], env_k[1], st["interp_y"], int(st["fade_p"]),
                   bool(st["disable"]))
            out_k = m4.m4mb_event(*ins)
            out_r = m4.m4mb_event_ref(*ins)
            torch.cuda.synchronize()
            for k, kind in m4.EV_LEAVES:
                a, b = out_k[0][k], out_r[0][k]
                if kind != "f":
                    _require(f"m4mb_event {words} at {fs} block {blk}: {k} differs from the "
                             f"plain version", torch.equal(a, b))
                else:
                    errs["m4mb_event"] = max(errs["m4mb_event"], _rel(a, b))
            _require(f"m4mb_event {words} at {fs} block {blk}: the thresholds differ from the "
                     f"plain version by {_diff(out_k[1], out_r[1]):.3e}", torch.equal(out_k[1], out_r[1]))
            for a, b in zip(out_k[2:], out_r[2:]):
                errs["m4mb_event"] = max(errs["m4mb_event"], _rel(a, b))
            a_ins = (e.audio, bands, st["fb_buf"], st["interp_c"], out_k[2], st["pf_m"])
            y_k, y_r = m4.m4mb_audio(*a_ins), m4.m4mb_audio_ref(*a_ins)
            errs["m4mb_audio"] = max(errs["m4mb_audio"], *(_diff(a, b) for a, b in zip(y_k, y_r)))
            st, _ = e.step(st, xb)
        ev = st["ev"]
        counters = {k: int(ev[k].sum()) for k in M4_DECISIONS}
        print(f"  {words} at {fs} Hz, B={B} (bank L={plan.L}): decisions and thresholds equal; "
              f"bank {dbfs(errs['bank']):.1f} dBFS, envelopes {errs['m4mb_env']:.3e}, engine floats "
              f"{errs['m4mb_event']:.3e} relative, audio {dbfs(errs['m4mb_audio']):.1f} dBFS; after "
              f"{int(ev['t'][0])} ticks, over the 13 bands {counters}")
        _require(f"matrix4_mb {words}: no event in the check's input",
                 counters["diff_count"] + counters["ord_count"] > 0)
        _require(f"bank {words}: {dbfs(errs['bank']):.1f} dBFS", dbfs(errs["bank"]) <= -290.0)
        _require(f"bank {words}: {errs['bank']:.3e} absolute", errs["bank"] <= K1_ABS)
        print(f"  m4mb_env {words} at {fs} Hz, B={B}: ticks and envelopes within {env_abs:.3e} "
              f"absolute (limit {ENV_ABS}); the bank within {errs['bank']:.3e}")
        _require(f"m4mb_env {words}: {errs['m4mb_env']:.3e}", errs["m4mb_env"] <= 1e-13)
        _require(f"m4mb_env {words}: {env_abs:.3e} absolute", env_abs <= ENV_ABS)
        errs["m4mb_env"] = env_abs
        _require(f"m4mb_event {words}: {errs['m4mb_event']:.3e}", errs["m4mb_event"] <= 1e-13)
        _require(f"m4mb_audio {words}: {dbfs(errs['m4mb_audio']):.1f} dBFS",
                 dbfs(errs["m4mb_audio"]) <= MB_AUDIO_DBFS)
        records["lti_blocked@bank"]["max_abs_err"] = max(records["lti_blocked@bank"]["max_abs_err"],
                                                         errs["bank"])
        for name in ("m4mb_env", "m4mb_event", "m4mb_audio"):
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], errs[name])
        n, C, L = plan.n, plan.C, plan.L
        bank_bytes = 8 * (2 * B * C + 4 * C * n + C * L + 2 * C * n * L + C * n * n + C)
        bank_flops = 2 * C * (B // L) * (L * (L - 1) // 2 + 2 * n * L + n * n) + 2 * B * C
        bank_st = st["bank"]["fused"]
        if L == 1:
            ms = cuda_ms(lambda: iir.lti_blocked(plan, bank_st, xt), 10)
            print(f"  the bank at L = 1, B={B}: kernel {ms:.4f} ms (bound "
                  f"{bound(bank_bytes, bank_flops)[0]:.6f} ms)")
        if fs == FS and words == "matrix4_mb -6":
            dev_ms = one_launch(f"the bank at L = {L}, B={B}",
                             lambda: iir.lti_blocked(plan, bank_st, xt))
            if B == 2048:
                records["lti_blocked@bank"]["device_ms"] = dev_ms
        if fs == FS and B == 2048:
            dev_ms = one_launch(f"m4mb_env {words} B={B}",
                             lambda: m4.m4mb_env(bands, st["env_m"], e.g_env, w))
            if words == "matrix4_mb -6":
                records["m4mb_env"]["device_ms"] = dev_ms
        if fs == FS and words == "matrix4_mb -6":
            mb_audio_launches(records["m4mb_audio"], m4.m4mb_audio, m4.m4mb_audio_ref, e.audio,
                              (bands, st["fb_buf"], st["interp_c"], out_k[2], st["pf_m"]), B,
                              lambda a, b: _diff(a, b) <= 10.0 ** (MB_AUDIO_DBFS / 20.0))
        if B == 65536:
            set_tick_us(records["m4mb_event"], B // 32, cuda_ms(lambda: m4.m4mb_event(*ins), 3))
        if (words, fs, B) != MB_KERNEL_CASES[0]:
            continue
        Nc, Lr, S = B // 32, e.ctl.p["buf_len"], m4.N_BANDS
        ins = (e.ctl, st["ev"], st["ev_thresh"], env_k[1], st["interp_y"], 0, False)
        a_ins = (e.audio, bands, st["fb_buf"], st["interp_c"], out_k[2], st["pf_m"])
        timed = {
            # the 26 lanes in and out, the tables; per chunk and lane the
            # L-tap FIR, V·x, P·s and the 40 x 40 carry
            "lti_blocked@bank": (lambda: iir.lti_blocked(plan, bank_st, xt),
                                 lambda: iir.lti_blocked_ref(plan, bank_st, xt),
                                 bank_bytes, bank_flops),
            # the bands in, the envelopes in and out, the ticks out; the
            # input and the EWMA's two operations a sample, envelope and band
            "m4mb_env": (lambda: m4.m4mb_env(bands, st["env_m"], e.g_env, w),
                         lambda: m4.m4mb_env_ref(bands, st["env_m"], e.g_env, w),
                         8 * (2 * B * S + 2 * 8 * S + 8 * Nc * S), 8 * 3 * B * S),
            # the 13 states in and out (about 80 values and 10 rings of L
            # each), the thresholds, the ticks in, the coefficient sets, the
            # window and the display out; about 300 operations a tick and band
            # for the engine, 13 x 12 for the modulation, 250 for the
            # epilogue, 7 a value for the insert
            "m4mb_event": (lambda: m4.m4mb_event(*ins), lambda: m4.m4mb_event_ref(*ins),
                           8 * (2 * S * (80 + 10 * Lr) + 2 * S + 8 * Nc * S + 3 * Nc * S * 12
                                + 2 * 4 * S * 12 + 2 * Nc * S),
                           (300 + 156 + 250) * S * Nc + 7 * S * 12 * Nc),
            # the bands and the delayed line in, the coefficient sets, the
            # states, the 4 signals out; per sample and band 12 interpolated
            # values (4 operations each), the matrix (12), two allpasses (10)
            # and the sums (6)
            "m4mb_audio": (lambda: m4.m4mb_audio(*a_ins), lambda: m4.m4mb_audio_ref(*a_ins),
                           8 * (2 * B * S + 2 * min(B, e.fb_buf_len) * S + 3 * (Nc + 1) * S * 12
                                + 2 * 4 * S + 4 * B),
                           (48 + 12 + 10 + 6) * S * B),
        }
        for name, (kern, plain, nbytes, flops) in timed.items():
            ms = cuda_ms(kern, 20)
            plain_ms = cuda_ms(plain, 2)
            set_times(records[name], ms, plain_ms, nbytes, flops)
            print(f"  {name} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{records[name]['bound_ms']:.6f} ms ({records[name]['bound_by']})")
        set_tick_us(records["m4mb_event"], Nc, records["m4mb_event"]["ms"])


def matrix4_mb_no_sync():
    """One matrix4_mb chain step (the phase-linearising FIR and the effect)
    does not synchronise: run_blocks over 16 blocks at B = 2048 of input
    already on the card, the status lines off, under
    torch.cuda.set_sync_debug_mode("error")."""
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_args
    from dsp_tpu_torch.core.types import StreamInfo

    cc = CompiledChain(build_chain_from_args(["matrix4_mb", "-6"], StreamInfo(FS, CHANNELS)),
                       2048, device="cuda")
    xs = torch.as_tensor(transient_signal(1.0)[: 20 * 2048], device="cuda").reshape(20, 2048,
                                                                                 CHANNELS)
    cc.run_blocks(xs[:4])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = cc.run_blocks(xs[4:])
    except RuntimeError as e:
        raise SmokeError(f"the matrix4_mb step synchronised: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _require("the matrix4_mb run without syncs gave non-finite output",
             bool(torch.isfinite(ys).all()))
    st = next(s for s in cc.states if isinstance(s, dict) and "ev_thresh" in s)
    print(f"matrix4_mb step: 16 blocks ran with no host sync, t = {int(st['ev']['t'][0])}")


def _tensors(out):
    """The tensors of a wrapper's output, nested tuples flattened."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return [out]


def lookback_phase():
    """K1, K11 and m4mb_audio share one look-back scratch a stream
    (csrc/lookback.cuh, kernels.lookback_scratch). Interleaves launches of
    different tile counts and widths on it, LOOKBACK_ROUNDS rounds on new
    inputs: the flagship at B = 65536 (128 slots of 12), the bank at B =
    2048 (104 slots of 40) and at its L = 1 plan (B = 1056), m4mb_env with
    the mix (16 slots of 104), m4mb_env_f32 and m4_env at B = 65536 (64
    slots of 8), m4mb_audio at B = 65536 (256 slots of 26 maps, 52 values)
    and 1056 (5), m4mb_audio_f32 at 2048 (8). Before each
    launch the aggregates' storage is filled with the words of that
    launch's own tag, so a flag read from anywhere but flag storage would
    release a tile early. Every output is held bit-equal to the same launch
    on a fresh scratch."""
    import numpy as np
    import torch

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    dev = torch.device("cuda")
    rng = np.random.default_rng(20262)
    flag_plan, _ = flagship_parts()
    e, _ = mb_effect("matrix4_mb filter_type=butterworth,freq_mask=0.5 -6", FS, 2048)
    g = e.g_env

    def arr(*shape, scale=0.3, dtype=torch.float64):
        return torch.as_tensor(rng.standard_normal(shape) * scale, device=dev).to(dtype)

    def inputs():
        bank, bank1 = e._bank_plan(2048), e._bank_plan(1056)
        w = e.device_array("fmw", arr(1))
        return [
            (iir.lti_blocked, (flag_plan, arr(2, CHANNELS, flag_plan.n, scale=1e-2),
                               arr(65536, CHANNELS))),
            (iir.lti_blocked, (bank, arr(2, 26, bank.n, scale=1e-2), arr(2048, 26))),
            (m4.m4mb_env, (arr(2048, 13, 2), arr(13, 8, scale=1e-2).abs(), g, w)),
            (iir.lti_blocked, (bank1, arr(2, 26, bank1.n, scale=1e-2), arr(1056, 26))),
            (m4.m4_env, (arr(65536, 2), arr(8, scale=1e-2).abs(), g)),
            (m4.m4mb_env_f32, (arr(2048, 13, 2, dtype=torch.float32),
                               arr(2048, 13, 2, scale=1e-9, dtype=torch.float32),
                               arr(13, 8, scale=1e-2, dtype=torch.float32).abs(),
                               arr(13, 8, scale=1e-11, dtype=torch.float32).abs(), g, w)),
            (m4.m4mb_audio, audio_args(65536)),
            (m4.m4mb_audio_f32, audio_args(2048, torch.float32)),
            (m4.m4mb_audio, audio_args(1056)),
        ]

    def audio_args(B, dtype=torch.float64):  # m4mb_audio's, the allpasses' coefficients in (-1, 1)
        sets = arr(B // 32 + 1, 3, 13, 12, scale=0.1, dtype=dtype)
        return (e.audio, arr(B, 13, 2, dtype=dtype), arr(e.audio.len, 13, 2, dtype=dtype),
                sets[0].contiguous(), sets[1:].contiguous(), arr(13, 2, 2, scale=0.05, dtype=dtype))

    rounds = [inputs() for _ in range(LOOKBACK_ROUNDS)]
    key = (0, kernels._stream(torch.empty(1, device=dev)))
    fresh = []
    for launches in rounds:
        for fn, args in launches:
            kernels._SCRATCH.pop(key, None)
            fresh.append(_tensors(fn(*args)))
    flags, agg = kernels.lookback_scratch(torch.empty(1, device=dev), 4096, 16)
    shared = []
    for launches in rounds:
        for fn, args in launches:
            agg.view(torch.int32).fill_(int(flags[2].item()) + 1)
            shared.append(_tensors(fn(*args)))
    torch.cuda.synchronize()
    _require("the look-back scratch was replaced during the shared run",
             kernels._SCRATCH[key][0] is flags and kernels._SCRATCH[key][1] is agg)
    for i, (a, b) in enumerate(zip(fresh, shared)):
        _require(f"launch {i} on the shared look-back scratch differs from the same launch on a "
                 f"fresh one", all(bits_equal(x, y) for x, y in zip(a, b)))
    print(f"look-back: {len(shared)} launches of K1, K11 and m4mb_audio interleaved on one scratch, the "
          f"aggregates' storage filled with each launch's tag: bit-equal to fresh scratches")


LOOKBACK_ROUNDS = 16


def program_signal(dur=4.0, fs=FS):
    """scripts/gen_bench_goldens.py's program material (crossing sweeps and
    tones, stereo), the input of bench_goldens/*.npz."""
    import numpy as np

    n = int(dur * fs)
    t = np.arange(n) / fs
    g = 10 ** (-14 / 20)
    v = np.log(16000 / 35)
    x = np.zeros((n, 2))
    x[:, 0] = g * (np.sin(35 / v * dur * (np.exp(v * t / dur) - 1)) + np.sin(2 * np.pi * 997 * t))
    x[:, 1] = g * (np.sin(2 * np.pi * 1497 * t)
                   + np.sin(16000 / np.log(35 / 16000) * dur * (np.exp(np.log(35 / 16000) * t / dur) - 1)))
    return x


def bench_golden_check():
    """bench_goldens/resample.npz and matrix4.npz (dsp_tpu float64 on the
    CPU, stored as float32 hi + lo) against the card: the 4 s program
    signal through `resample 192k` and `matrix4 -6` at block 65536, raw
    (zero-padded whole blocks from the initial state, no drain or discard),
    as gen_bench_goldens.render_blocks renders them; within -200 dBFS."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    x = program_signal()
    for name, words in (("resample", "resample 192k"), ("matrix4", "matrix4 -6")):
        z = np.load(ROOT / "bench_goldens" / f"{name}.npz")
        want = z["hi"].astype(np.float64) + z["lo"].astype(np.float64)
        cc = CompiledChain(build_chain_from_string(words, StreamInfo(FS, CHANNELS)), 65536,
                           device="cuda")
        B = cc.block_frames
        n_blocks = -(-len(x) // B)
        xp = np.zeros((n_blocks * B, CHANNELS))
        xp[: len(x)] = x
        ys = cc.run_blocks(xp.reshape(n_blocks, B, CHANNELS))
        got = ys.reshape(-1, ys.shape[-1]).to("cpu", torch.float64).numpy()
        got = got[: int(len(x) * float(cc.chain.ratio))]
        _require(f"bench golden {name}: {got.shape} against {want.shape}", got.shape == want.shape)
        check_close(f"bench_goldens/{name}.npz ({words}, -b 65536) on the card vs dsp_tpu f64",
                    float(np.abs(got - want).max()))


# bench.py's matrix4_mb accuracy check (_matrix4_mb_accuracy): dsp_tpu f64's
# control stream, stored as float32 coefficient sets a tick, replayed
# through the audio path. The float32 sets bound it: measured -120.8 dBFS on
# an NVIDIA H100 80GB HBM3 (700 W), at BASELINE's -120 dBFS budget, which is
# the limit
MB_REPLAY_DBFS = -120.0


def mb_golden_check():
    """bench_goldens/matrix4_mb.npz (dsp_tpu f64, `matrix4_mb -6` on the 4 s
    program signal, raw from the initial state, with its control stream:
    the interpolator's coefficient sets of every tick, fitted and stored as
    float32) on the card. The replay: the phase-linearising FIR and the
    effect's control path run on the card, the golden's coefficient sets
    replace the engines' in the audio path (as bench.py replays them), at
    block 32768; the output within MB_REPLAY_DBFS of the golden. Then the
    free run (the card's own control) against the golden, a second at a
    time, for information: the engine is chaotic where a band sits at
    crosstalk level (PARITY.md)."""
    import numpy as np
    import torch

    from dsp_tpu_torch.effects.fir import FirEffect
    from dsp_tpu_torch.effects.matrix4_mb import Matrix4MbEffect

    z = np.load(ROOT / "bench_goldens" / "matrix4_mb.npz")
    want = z["hi"].astype(np.float64) + z["lo"].astype(np.float64)
    gold_ics = torch.as_tensor(z["ics"].astype(np.float64), device="cuda")
    x = program_signal()
    B = 32768
    n_blocks = -(-len(x) // B)
    xp = np.zeros((n_blocks * B, CHANNELS))
    xp[: len(x)] = x
    xs = torch.as_tensor(xp, device="cuda")
    Nc = B // 32
    # hold the last coefficient set over the padding, as bench.py does
    pad = n_blocks * Nc - gold_ics.shape[0]
    gold_ics = torch.cat([gold_ics, gold_ics[-1:].expand(pad, *gold_ics.shape[1:])])
    for mode in ("replay", "free run"):
        from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
        from dsp_tpu_torch.core.types import StreamInfo

        cc = CompiledChain(build_chain_from_string("matrix4_mb -6", StreamInfo(FS, CHANNELS)), B,
                           device="cuda")
        fir = next(e for e in cc.chain.effects if isinstance(e, FirEffect))
        mb = next(e for e in cc.chain.effects if isinstance(e, Matrix4MbEffect))
        fst, mst = cc._initial_state(fir), cc._initial_state(mb)
        ys = []
        for i in range(n_blocks):
            fst, xf = fir.step(fst, xs[i * B:(i + 1) * B])
            ctl = mb._control(mst, xf)
            if mode == "replay":
                ctl = dict(ctl, ics=gold_ics[i * Nc:(i + 1) * Nc].contiguous())
            mst, y = mb._audio(mst, xf, ctl)
            ys.append(y)
        got = torch.cat(ys).cpu().numpy()[: len(want)]
        err = float(np.abs(got - want).max())
        if mode == "replay":
            print(f"bench_goldens/matrix4_mb.npz, the golden's control replayed on the card, "
                  f"-b {B}: max |diff| {err:.3e} ({dbfs(err):.1f} dBFS, limit {MB_REPLAY_DBFS})")
            _require(f"matrix4_mb golden replay at {dbfs(err):.1f} dBFS", dbfs(err) <= MB_REPLAY_DBFS)
        else:
            per_s = [float(np.abs(got[i:i + FS] - want[i:i + FS]).max()) for i in range(0, len(want), FS)]
            print("bench_goldens/matrix4_mb.npz, free run on the card, a second at a time (dBFS): "
                  + " ".join(f"{dbfs(e):.1f}" for e in per_s))


def write_input(path, seconds):
    """Seeded stereo test signal: sines summing to -6 dBFS plus noise."""
    import numpy as np

    from dsp_tpu_torch.codecs.base import CODEC_MODE_WRITE, CodecParams
    from dsp_tpu_torch.codecs.wav import WavWriter

    rng = np.random.default_rng(7)
    n = seconds * FS
    w = WavWriter(CodecParams(path=str(path), enc="double", fs=FS, channels=CHANNELS,
                              mode=CODEC_MODE_WRITE))
    head = None
    step = 1 << 20
    try:
        for t0 in range(0, n, step):
            t = np.arange(t0, min(n, t0 + step))[:, None] / FS
            x = 0.25 * np.sin(2 * np.pi * np.array([55.0, 440.0]) * t)
            x += 0.25 * np.sin(2 * np.pi * np.array([1000.0, 6000.0]) * t)
            x += 0.01 * rng.standard_normal(x.shape)
            w.write(x)
            if head is None:
                head = x[: COMPARE_SECONDS * FS].copy()
    finally:
        w.close()
    return n, head


def read_wav(path, frames=None):
    from dsp_tpu_torch.codecs.base import CodecParams
    from dsp_tpu_torch.codecs.wav import WavReader

    r = WavReader(CodecParams(path=str(path)))
    try:
        total = r.frames
        return total, r.read(total if frames is None else min(frames, total))
    finally:
        r.close()


def write_filter(path, taps, seed):
    """Seeded flat-noise impulse response, mono, scaled to an L1 norm of
    0.5 so the output stays inside full scale; every partition, the tail
    included, carries weight."""
    import numpy as np

    from dsp_tpu_torch.codecs.base import CODEC_MODE_WRITE, CodecParams
    from dsp_tpu_torch.codecs.wav import WavWriter

    h = np.random.default_rng(seed).standard_normal((taps, 1))
    h *= 0.5 / np.abs(h).sum(axis=0).max()
    w = WavWriter(CodecParams(path=str(path), enc="double", fs=FS, channels=1,
                              mode=CODEC_MODE_WRITE))
    try:
        w.write(h)
    finally:
        w.close()


def cpu_reference(chain_words, block, enc, seed, head, dtype=None):
    """The port's CPU run of chain_words at `block` on head (the input's
    first seconds), through what the CLI's writer does for enc: its dither
    policy, its app-level dither, the clip and the encoding. With `seed`,
    numpy's global generator is seeded before the chain is built, which
    then draws as the CLI does (the chain's init, the output writer's two
    dither seeds, the effects' initial states). dtype: the chain's (None:
    DSP_TPU_TORCH_DTYPE's). What cli_run compares the card's render with;
    module-level, so a CpuReferences worker runs it."""
    import numpy as np

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_args
    from dsp_tpu_torch.chain.chain import chain_set_dither_params
    from dsp_tpu_torch.codecs.sampleconv import encoding_info, raw_to_sample, sample_to_raw
    from dsp_tpu_torch.core.prng import TpdfNoise, tpdf_dither_get_mult
    from dsp_tpu_torch.core.types import StreamInfo

    if seed is not None:
        np.random.seed(seed)
    chain = build_chain_from_args(chain_words, StreamInfo(FS, CHANNELS))
    # the output writer's two seeds for its app-level dither, drawn as the
    # CLI draws them (cli/main.py OutputWriter), and the CLI's dither policy
    seeds = np.random.randint(1, 1 << 30), np.random.randint(1, 1 << 30)
    prec, can_dither = encoding_info(enc)[1:]
    app_dither = chain_set_dither_params(chain, prec, can_dither and prec < 24)
    ref = CompiledChain(chain, block, dtype=dtype, device="cpu").process_array(head, drain=False)
    if app_dither:
        # the alignment pass can put an align effect after a dither effect
        # (delivery: the delay's integer part), and then the writer dithers
        # too, as dsp_tpu's does
        ref = ref + TpdfNoise(*seeds).block(ref.size, tpdf_dither_get_mult(prec)).reshape(ref.shape)
    # what the writer stores and read_wav returns: clipped, encoded, decoded
    return raw_to_sample(sample_to_raw(np.clip(ref, -1.0, 1.0), enc), enc).reshape(ref.shape)


def cli_stats_table(label, words, enc, head, path, device, dtype=None):
    """The stats table that dsp-torch prints on `device` for `words` on
    head (written to `path` as a float64 wav, the run's output beside it),
    numpy's generator seeded with SLICE_C_SEED, in dtype (None: float64):
    what stats_table_check compares; module-level, so a CpuReferences
    worker runs the CPU's. Returns (label, the table or None)."""
    import contextlib
    import io
    import os

    import numpy as np

    from dsp_tpu_torch.cli.main import main as cli_main
    from dsp_tpu_torch.codecs.base import CODEC_MODE_WRITE, CodecParams
    from dsp_tpu_torch.codecs.wav import WavWriter

    path = Path(path)
    w = WavWriter(CodecParams(path=str(path), enc="double", fs=FS, channels=CHANNELS,
                              mode=CODEC_MODE_WRITE))
    try:
        w.write(head)
    finally:
        w.close()
    env = {"DSP_TPU_TORCH_DEVICE": device, "DSP_TPU_TORCH_DTYPE": dtype or "float64"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        np.random.seed(SLICE_C_SEED)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli_main(["-q", str(path), "-o", "-e", enc, str(path.with_suffix(".out.wav")),
                           *words.split()])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise SmokeError(f"{label} stats table run on {device}: dsp-torch exited {rc}")
    return label, stats_table(err.getvalue())


def _reference_worker():
    import os

    os.environ["DSP_TPU_TORCH_DEVICE"] = "cpu"


class CpuReferences:
    """cli_run's CPU runs (cpu_reference), submitted ahead and computed in
    worker processes while the card renders: each takes seconds of the
    port's plain versions a second of input (matrix4's event engine is a
    loop of torch ops a tick), against a fraction of a second on the card.
    A run is keyed by everything it depends on, the input's bytes
    included, so cli_run takes only the reference of its own run. The
    workers start with spawn and never touch the card; close() stops
    them."""

    def __init__(self, workers):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                        initializer=_reference_worker)
        self.jobs = {}

    @staticmethod
    def _key(chain_words, block, enc, seed, head, dtype=None):
        import hashlib

        return (tuple(chain_words), block, enc, seed, head.shape,
                hashlib.sha256(head.tobytes()).hexdigest(), dtype)

    def submit(self, chain_words, block, head, enc="double", seed=None, compare=COMPARE_SECONDS,
               dtype=None):
        head = head[: compare * FS]
        self.jobs[self._key(chain_words, block, enc, seed, head, dtype)] = self.pool.submit(
            cpu_reference, list(chain_words), block, enc, seed, head, dtype)

    def take(self, chain_words, block, enc, seed, head, dtype=None):
        """The reference computed for this run, or None if none was submitted."""
        job = self.jobs.pop(self._key(chain_words, block, enc, seed, head, dtype), None)
        return None if job is None else job.result()

    def submit_tables(self, head, tmp, dtype=None):
        """stats_table_check's CPU runs (cli_stats_table) of the delivery
        and modulated chains on head (its first COMPARE_SECONDS)."""
        head = head[: COMPARE_SECONDS * FS]
        for label, words, enc in TABLE_CHAINS:
            self.jobs[("table", label, dtype)] = self.pool.submit(
                cli_stats_table, label, words, enc, head, tmp / f"table_{label}_{dtype}.wav",
                "cpu", dtype)

    def take_table(self, label, dtype=None):
        """The CPU table computed for this label and dtype, or None."""
        job = self.jobs.pop(("table", label, dtype), None)
        return None if job is None else job.result()[1]

    def close(self):
        """Stop the workers (a job not yet started is cancelled); return
        the number of jobs submitted and never taken."""
        left = len(self.jobs)
        self.jobs.clear()
        self.pool.shutdown(wait=True, cancel_futures=True)
        return left


WALLS = {}  # cli_run's wall seconds a run, by label


def cli_run(label, chain_words, block, wrappers, records, src, n_in, head, seconds, tmp,
            enc="double", limit_dbfs=LIMIT_DBFS, seed=None, onset=None, compare=COMPARE_SECONDS,
            keep=None, refs=None, dtype=None):
    """One file-to-file run of dsp-torch on the card. Fails unless it
    writes the expected frame count, launches every kernel in `wrappers`
    (their counts are zeroed just before the run) and matches the port's
    CPU run (cpu_reference) on the first `compare` seconds within
    `limit_dbfs` (None: equal). With `seed`, numpy's global generator is
    seeded before the card run and before the CPU run's chain, which then
    draws as the CLI does. With `onset` = (seconds, dBFS), the output's
    first seconds are held to that limit instead (see ONSET). With `keep`
    (a path), the run's output file is kept there (the float32 phase holds
    its own runs against it). With `refs` (CpuReferences), the CPU run is
    the one computed there ahead, if one was, else it runs here; dtype
    the CPU run's (None: DSP_TPU_TORCH_DTYPE's). Returns what the run wrote
    to stderr."""
    import contextlib
    import io

    import numpy as np

    from dsp_tpu_torch.chain import build_chain_from_args
    from dsp_tpu_torch.chain.chain import expected_out_frames
    from dsp_tpu_torch.cli.main import main as cli_main
    from dsp_tpu_torch.core.types import StreamInfo

    chain = build_chain_from_args(chain_words, StreamInfo(FS, CHANNELS))
    want = expected_out_frames(chain, n_in) - chain.output_discard
    out = tmp / "out.wav"
    argv = (["-b", str(block)] if block != 2048 else []) + [
        "-q", str(src), "-o", "-e", enc, str(out), *chain_words]
    for w in wrappers.values():
        w.launches = 0
    if seed is not None:
        np.random.seed(seed)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    wall = WALLS[label] = time.perf_counter() - t0
    counts = {name: w.launches for name, w in wrappers.items()}
    if rc != 0:
        raise SmokeError(f"{label}: dsp-torch exited {rc}: {err.getvalue()[-2000:]}")
    print(f"  {label}: {wall:.3f} s wall, {seconds / wall:.1f}x realtime, launches {counts}")
    for name, c in counts.items():
        if c <= 0:
            raise SmokeError(f"{label}: {name} kernel was not launched")
        records[name]["launches"] += c
    head = head[: compare * FS]
    got, y = read_wav(out, compare * chain.ostream.fs)
    if got != want:
        raise SmokeError(f"{label}: {got} output frames, expected {want}")
    ref = None if refs is None else refs.take(chain_words, block, enc, seed, head, dtype)
    if ref is None:
        ref = cpu_reference(chain_words, block, enc, seed, head, dtype)
    if not np.isfinite(y).all():
        raise SmokeError(f"{label}: non-finite output")
    if len(ref) == 0 or len(y) < len(ref):
        raise SmokeError(f"{label}: {len(y)} frames to compare with {len(ref)} of the CPU run")
    what = f"{label}: first {compare} s vs the port on the CPU"
    y = y[: len(ref)]
    if onset is not None:
        fs_out = chain.ostream.fs
        per_s = [float(np.abs(y[i:i + fs_out] - ref[i:i + fs_out]).max())
                 for i in range(0, len(ref), fs_out)]
        print(f"  {label}: vs the port on the CPU, a second at a time (dBFS): "
              + " ".join(f"{dbfs(e):.1f}" for e in per_s))
        n0 = int(onset[0] * fs_out)
        early = float(np.abs(y[:n0] - ref[:n0]).max())
        print(f"  {label}: first {onset[0]} s vs the port on the CPU: max |diff| {early:.3e} "
              f"({dbfs(early):.1f} dBFS, limit {onset[1]})")
        if not dbfs(early) <= onset[1]:
            raise SmokeError(f"{label}: first {onset[0]} s at {dbfs(early):.1f} dBFS")
        what = f"{label}: {onset[0]} s to {compare} s vs the port on the CPU"
        y, ref = y[n0:], ref[n0:]
    diff = float(np.abs(y - ref).max())
    if limit_dbfs is None:
        print(f"  {what}: max |diff| {diff:.3e}")
        if diff != 0.0:
            raise SmokeError(f"{what}: not equal")
    else:
        print(f"  {what}: max |diff| {diff:.3e} ({dbfs(diff):.1f} dBFS)")
        if not dbfs(diff) <= limit_dbfs:
            raise SmokeError(f"{what}: {dbfs(diff):.1f} dBFS is above {limit_dbfs} dBFS")
    if keep is None:
        out.unlink()
    else:
        out.replace(keep)
    return err.getvalue()


def stats_table(text):
    """The stats table in a run's stderr: the "Channel" row to the blank
    line after the table, or None."""
    lines = text.splitlines()
    start = next((i for i, l in enumerate(lines) if l.startswith("Channel ")), None)
    if start is None:
        return None
    end = next((i for i in range(start, len(lines)) if not lines[i].strip()), len(lines))
    return "\n".join(lines[start:end])


def stats_table_check(head, tmp, refs, dtype=None):
    """The stats tables of the delivery chain (stats -i, to s16) and the
    modulated chain (plain stats and levels, to double) from the CLI on the
    card and on the CPU, on the same COMPARE_SECONDS of input, numpy's
    generator seeded alike: equal character for character (min, max, peak,
    peak count and frame are exact; the sums print to 8 decimals and 4 of
    a dB). The CPU tables come from refs (CpuReferences.submit_tables, run
    ahead in its workers); dtype the chains' (None: float64)."""
    for label, words, enc in TABLE_CHAINS:
        card = cli_stats_table(label, words, enc, head, tmp / "head.wav", "cuda", dtype)[1]
        cpu = refs.take_table(label, dtype)
        if card is None or card != cpu:
            raise SmokeError(f"{label} stats table, card:\n{card}\nCPU:\n{cpu}")
        print(f"  {label} stats table on {COMPARE_SECONDS} s: card and CPU equal")


def delivery_no_sync():
    """The delivery chain's step does not synchronise, in float64 and in
    float32: run_blocks over 320 blocks at B = 2048 of input already on the
    card, under torch.cuda.set_sync_debug_mode("error")."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_args
    from dsp_tpu_torch.chain.chain import chain_set_dither_params
    from dsp_tpu_torch.core.types import StreamInfo

    for dtype in (torch.float64, torch.float32):
        chain = build_chain_from_args(DELIVERY.split(), StreamInfo(FS, CHANNELS))
        chain_set_dither_params(chain, 16, True)
        cc = CompiledChain(chain, 2048, dtype=dtype, device="cuda")
        rng = np.random.default_rng(12)
        warm = torch.as_tensor(rng.standard_normal((8, 2048, CHANNELS)) * 0.1, dtype=dtype,
                               device="cuda")
        xs = torch.as_tensor(rng.standard_normal((320, 2048, CHANNELS)) * 0.1, dtype=dtype,
                             device="cuda")
        cc.run_blocks(warm)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ys = cc.run_blocks(xs)
        except RuntimeError as e:
            raise SmokeError(f"the {dtype} delivery chain's step synchronised: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if ys.dtype != dtype or not torch.isfinite(ys).all():
            raise SmokeError(f"the {dtype} delivery chain's run without syncs gave output "
                             f"{ys.dtype}, finite {bool(torch.isfinite(ys).all())}")
        print(f"delivery step ({dtype}): 320 blocks ran with no host sync, stats samples = "
              f"{int(cc.states[-1]['samples'])}")


# kernels a block of the profiled chains before the FFT-convolution
# transforms ran in one launch and the engines' carried input moved into
# rfft_pack (PERF.md section 5: the profiles of the float32 slices, on
# NVIDIA H100 80GB HBM3 at 700 W); a chain may not launch more now
OLD_KERNELS_A_BLOCK = {
    "delivery": 8, "modulated": 10, "matrix4": 10, "matrix4_mb": 36,
    "delivery float32": 8, "modulated float32": 10,
    "flagship -b 2048 float64": 33, "flagship -b 2048 float32": 33,
    "flagship -b 1000 float64": 54, "flagship -b 1000 float32": 36,
    "resample 48k -b 2048 float64": 15, "resample 48k -b 2048 float32": 10,
    "matrix4 -6 -b 2048 float64": 10, "matrix4 -6 -b 2048 float32": 10,
    "matrix4_mb -6 -b 2048 float64": 36, "matrix4_mb -6 -b 2048 float32": 36,
    "fir 64k -b 2048 float64": 10, "fir 64k -b 2048 float32": 10,
}
# what the one-launch transforms must bring them to: the Upols step is
# rfft_pack, fdl_mac and irfft_crop; the float32 resampler step
# rfft_pack_f32 (reading the inner blocks in place), the fold and
# irfft_ola_f32; and K2's launches in one each: crossfeed's step one
# launch for 15 (the flagship from 33 to 19 at -b 2048 and from 54 and 36
# to 22 at -b 1000), the per-sample biquad one for 4, matrix4's band-limit
# pair one for 3 (10 to 8; PERF.md sections 5 and 6); K1 in one launch
# for 3 (the flagship from 19 to 17, matrix4_mb from 27 to 25, float32
# matrix4's band-limit from 10 to 8); and a run of per-sample biquads in
# one launch (the flagship's six at -b 1000 from 22 to 17; matrix4_mb's
# two cascades, with their stack and state copies, 9 kernels to 2: 25 to
# 18, in both dtypes); matrix4_mb's audio path in one launch for 2 (18 to
# 17) and the modulated delay's step in one for 3 (the modulated chain
# from 10 to 8), in both dtypes; the resampler's step in one launch (the
# float64 step from 7.8 to 1, the float32 from 2.8 to 1)
MOST_KERNELS_A_BLOCK = {
    "fir 64k -b 2048 float64": 3, "fir 64k -b 2048 float32": 3,
    "resample 48k -b 2048 float64": 1, "resample 48k -b 2048 float32": 1,
    "flagship -b 2048 float64": 17, "flagship -b 2048 float32": 17,
    "flagship -b 1000 float64": 17, "flagship -b 1000 float32": 17,
    "matrix4": 8, "matrix4 -6 -b 2048 float64": 8, "matrix4 -6 -b 2048 float32": 8,
    "matrix4_mb": 17, "matrix4_mb -6 -b 2048 float64": 17, "matrix4_mb -6 -b 2048 float32": 17,
    "modulated": 8, "modulated float32": 8,
}
# chains profiled at -b 65536 too (8 blocks each), where the card sets the
# pace: K1's and K11's tiles over the card
PROFILE_65536 = ((FLAGSHIP, "flagship"), (MATRIX4, "matrix4 -6"), (MATRIX4_MB, "matrix4_mb -6"))


def profile_chains(f4k, f64k):
    """Where a block's time goes in slice C's chains (in both dtypes), slices D and E's
    upmixes, slice F's (matrix4_mb and the mixed chain with the 4,096-tap
    filter f4k) and the float32 mode's chains (F32_RUNS, F32_UPMIXES, and
    `fir` with the 65,536-tap filter f64k at block 2048) beside their
    float64 twins:
    CompiledChain.run_blocks over 128 blocks on the card (8 at -b 65536:
    PROFILE_65536),
    timed unprofiled (host clock to a synchronize), then under
    torch.profiler for the device time of each kernel. Prints the step time
    a block, the kernels the card ran a block, the device time a block by
    kernel, and the device's busy share of the unprofiled step."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_args
    from dsp_tpu_torch.chain.chain import chain_set_dither_params
    from dsp_tpu_torch.core.types import StreamInfo

    rng = np.random.default_rng(13)
    f64, f32 = torch.float64, torch.float32
    runs = [(label, words, prec, 2048, f64) for label, words, prec in (
        ("delivery", DELIVERY, 16), ("modulated", MODULATED, 53), ("matrix4", MATRIX4, 53),
        ("upmix48", UPMIX48, 53), ("matrix4_mb", MATRIX4_MB, 53),
        ("mixed", mixed_chain(f4k), 53))]
    runs += [("delivery float32", DELIVERY, 16, 2048, f32),
             ("modulated float32", MODULATED, 53, 2048, f32)]
    for words, block in F32_RUNS + F32_UPMIXES + ((f"fir {f64k}", 2048),):
        name = "flagship" if words == FLAGSHIP else words.replace(str(f64k), "64k")
        label = f"{name} -b {block}"
        runs += [(f"{label} float64", words, 53, block, f64),
                 (f"{label} float32", words, 53, block, f32)]
    runs += [(f"{name} -b 65536 float64", words, 53, 65536, f64) for words, name in PROFILE_65536]
    for label, words, prec, block, dtype in runs:
        n = 8 if block == 65536 else 128
        np.random.seed(SLICE_C_SEED)
        chain = build_chain_from_args(words.split(), StreamInfo(FS, CHANNELS))
        chain_set_dither_params(chain, prec, prec < 24)
        cc = CompiledChain(chain, block, dtype=dtype, device="cuda")
        B = cc.block_frames
        if label in ("upmix48", "mixed") or label.startswith("matrix4"):
            x = transient_signal((n + 8) * B / FS + 0.01)[: (n + 8) * B]
        else:
            x = rng.standard_normal(((n + 8) * B, CHANNELS)) * 0.1
        xs = torch.as_tensor(x, dtype=dtype, device="cuda").reshape(n + 8, B, CHANNELS)
        cc.run_blocks(xs[:8])
        xs = xs[8:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cc.run_blocks(xs)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        by_name, kernels, tries = {}, 0, 3
        for _ in range(tries):  # a profile can come back empty: take it again
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                cc.run_blocks(xs)
                torch.cuda.synchronize()
            for e in prof.events():  # the kernels the card ran, by name
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
                    kernels += 1
            if kernels:
                break
        limits = [v for v in (OLD_KERNELS_A_BLOCK.get(label), MOST_KERNELS_A_BLOCK.get(label))
                  if v is not None]
        if not kernels and limits:
            raise SmokeError(f"profile {label}: torch.profiler recorded no kernel in {tries} "
                             f"tries, so its limit of {min(limits)} kernels a block is unchecked")
        dev_ms = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        old = OLD_KERNELS_A_BLOCK.get(label)
        print(f"profile {label} (B={B}, {n} blocks): step {step_ms:.4f} ms a block unprofiled "
              f"({B / FS * 1e3 / step_ms:.1f}x realtime), {kernels / n:.1f} kernels a block "
              f"(before the one-launch transforms: {'not profiled' if old is None else old}), "
              f"device {dev_ms:.4f} ms a block ({100 * dev_ms / step_ms:.1f}% of the step)")
        for name, ms in top:
            print(f"  {ms:.4f} ms ({100 * ms / dev_ms:.1f}%)  {name[:90]}")
        # (a profile can miss or add an event of 128 blocks: the count rounds)
        if limits and round(kernels / n) > min(limits):
            raise SmokeError(f"profile {label}: {kernels / n:.2f} kernels a block, "
                             f"at most {min(limits)}")


F32_STATE_REL = 1e-13  # a (hi, lo) state's hi + lo, kernel against plain version


def _ulps(got, want):
    """max |got - want| in float32 ulps of the output scale (the spacing of
    float32 numbers at max |want|), and the max |got - want|."""
    got, want = got.cpu().double(), want.cpu().double()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    if scale == 0.0:
        return (0.0 if err == 0.0 else math.inf), err
    return err / 2.0 ** (math.floor(math.log2(scale)) - 23), err


def _pair_rel(a, b):
    """max |(a_hi + a_lo) - (b_hi + b_lo)| over float32 (hi, lo) pairs,
    relative to max |b_hi + b_lo|."""
    sa, sb = (p[0].cpu().double() + p[1].cpu().double() for p in (a, b))
    scale = float(sb.abs().max())
    return float((sa - sb).abs().max()) / scale if scale > 0 else float((sa - sb).abs().max())


def _hold_f32(rec, what, y_k, y_r, st_k=None, st_r=None):
    """Fail unless the float32 output y is within one float32 ulp of its
    scale of the plain version's and the (hi, lo) state's sum within
    F32_STATE_REL; records the max |diff| of y."""
    ulps, err = _ulps(y_k, y_r)
    rel = 0.0 if st_k is None else _pair_rel(st_k, st_r)
    equal = torch_equal(y_k, y_r) and (st_k is None or torch_equal(st_k, st_r))
    print(f"  {what}: {'equal' if equal else f'y within {ulps:.2f} ulp of its scale'}"
          + ("" if st_k is None else f", state hi + lo within {rel:.2e} relative"))
    _require(f"{what}: y {ulps:.2f} ulp of its scale from the plain version", ulps <= 1.0)
    _require(f"{what}: state {rel:.2e} relative from the plain version", rel <= F32_STATE_REL)
    rec["max_abs_err"] = max(rec["max_abs_err"], err)


def torch_equal(a, b):
    import torch

    return torch.equal(a.cpu(), b.cpu())


def _f32_state(e, dev):
    """An effect's numpy state0 as a float32 chain holds it: float leaves
    float32, keys and counters in their own dtypes."""
    import numpy as np
    import torch

    out = {}
    for k, v in e.state0().items():
        v = np.asarray(v)
        dt = torch.float32 if v.dtype.kind == "f" else None
        out[k] = torch.as_tensor(v, dtype=dt, device=dev)
    return out


def _hold_td32(rec, what, got, want, exact=()):
    """Fail unless each (name, kernel, plain) float leaf is within one
    float32 ulp of its scale and each leaf named in `exact` (draws,
    decisions, quantized output, counts) is equal; records the max |diff|."""
    worst = 0.0
    for name, a, b in zip(got[0], got[1], want):
        if name in exact or not a.dtype.is_floating_point:
            _require(f"{what}: {name} differs from the plain version", torch_equal(a, b))
            continue
        ulps, err = _ulps(a, b)
        _require(f"{what}: {name} {ulps:.2f} ulp of its scale from the plain version",
                 ulps <= 1.0)
        worst = max(worst, ulps)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return worst


def float32_time_domain_phase(records):
    """Slice J4's float32 kernels against their plain versions at the main
    path's shape (B = 2048, stereo), each over 3 blocks carried through its
    state; the plain version runs on a host copy of the same inputs, which
    tests/test_torch_f32_time_domain.py holds to dsp_tpu float32. The draws
    and every decision equal: keys, noise, the dither's quantized output,
    error history and noise carry, the modulator's knots and phase, the
    stats counts and frames, min, max, peak and the -i estimator's state;
    float outputs (the modulated read, the stats sums, the levels meters)
    within one float32 ulp of their scale. Configurations: noise with and
    without a channel selection; dither in all six shapes at 16 bits (wan3
    and wan9 at 48 kHz); delay -m and -M at q0, q1 and q2 with the modulator
    at 1 kHz (a knot every 22 samples); stats plain and -i on quantized
    input (a limit in the third block); levels. Times each kernel and its
    plain version with CUDA events."""
    import numpy as np
    import torch

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.delay import ModDelayEffect
    from dsp_tpu_torch.effects.dither import DitherEffect
    from dsp_tpu_torch.effects.stats import StatsEffect
    from dsp_tpu_torch.ops import time_domain as td

    dev = torch.device("cuda")
    rng = np.random.default_rng(20265)
    B, C = 2048, CHANNELS
    f32 = torch.float32

    def block(scale=0.3):
        return torch.as_tensor(rng.standard_normal((B, C)) * scale, dtype=f32, device=dev)

    print("K18-noise tpdf_noise_f32 (float32 draws, stereo)")
    noise_cases(records["tpdf_noise_f32"], f32, rng)

    print("K15 tpdf_dither_f32 (all six shapes at 16 bits, B=2048, stereo, 3 blocks)")
    rec = records["tpdf_dither_f32"]
    for shape in ("flat", "sloped", "sloped2", "lipshitz", "wan3", "wan9"):
        fs = 48000 if shape.startswith("wan") else FS
        e = DitherEffect("dither", StreamInfo(fs, C), np.ones(C, dtype=bool), shape, 16.0, 16,
                         False, False, seed=4243)
        args = [torch.as_tensor(v, dtype=None if v.dtype == bool else f32, device=dev)
                for v in (e.n_mult, e.q_mult0, e.q_mult1, e.enabled, e.fir)]
        st = _f32_state(e, dev)
        for blk in range(3):
            xin = block()
            ins = [st["key"], xin, st["ehist"], st["nprev"], *args]
            out_k = td.tpdf_dither_f32(*ins, e.mode)
            out_r = td.tpdf_dither_f32_ref(*_to_cpu(ins), e.mode)
            names = ("key", "ehist", "nprev", "y")
            _hold_td32(rec, f"tpdf_dither_f32 {shape} block {blk}", (names, out_k), out_r,
                       exact=names)
            st = dict(zip(("key", "ehist", "nprev"), out_k[:3]))
        if shape == "lipshitz":
            ins = [st["key"], xin, st["ehist"], st["nprev"], *args]
            ms = cuda_ms(lambda: td.tpdf_dither_f32(*ins, e.mode), 50)
            plain_ms = cuda_ms(lambda: td.tpdf_dither_f32_ref(*ins, e.mode), 2)
            # x in, y out, the states; 2 float32 operations a sample for the
            # noise, 23 for the 9-tap feedback quantizer; each channel is a
            # chain of B dependent steps
            set_times(rec, ms, plain_ms, 8 * B * C + 4 * C * 22 + 16, 25 * B * C, peak=F32_PEAK)
            print(f"  lipshitz: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"(a chain of {B} samples a channel)")
        print(f"  {shape}: key, ehist, nprev and y equal over 3 blocks")
    dither_cases(f32, rng)

    print("K16 stats_step_f32 (B=2048, stereo, quantized input; 3 blocks, a limit in the third)")
    rec = records["stats_step_f32"]
    rec["times"] = []
    q = torch.as_tensor(np.round(rng.standard_normal((3, B, C)) * 0.3 * 32768) / 32768,
                        dtype=f32, device=dev)
    for interp in (False, True):
        e = StatsEffect("stats", StreamInfo(FS, C), np.ones(C, dtype=bool), None, 80, interp)
        table = torch.as_tensor(e._insert_table, dtype=f32, device=dev) if interp else None
        st = _f32_state(e, dev)
        sr = _to_cpu(st)
        for blk in range(3):
            if blk == 2:
                st["limit"] = torch.tensor(2 * B + 1000, device=dev)
                sr["limit"] = st["limit"].cpu()
            lib = kernels.meter_launches()[0]
            st = td.stats_step_f32(st, q[blk], table)
            _require(f"stats_step_f32 {'-i' if interp else 'plain'}: not one launch by the "
                     f"library's count", kernels.meter_launches()[0] - lib == 1)
            sr = td.stats_step_ref(sr, q[blk].cpu(), None if table is None else table.cpu())
            torch.cuda.synchronize()
            names = tuple(st)
            _hold_td32(rec, f"stats_step_f32 {'-i' if interp else 'plain'} block {blk}",
                       (names, [st[k] for k in names]), [sr[k] for k in names],
                       exact=tuple(k for k in names if k not in ("sum", "sum_sq")))
        s0 = _f32_state(e, dev)
        ms = cuda_ms(lambda: td.stats_step_f32(s0, q[0], table), 50)
        plain_ms = cuda_ms(lambda: td.stats_step_ref(s0, q[0], table), 2)
        gated = td.stats_step_ref.gated_samples if interp else 0
        state_bytes = 4 * 5 * C * 2 + 8 * (2 * C * 2 + 2) + (4 * C * 2 * 81 + 67 * 4 if interp else 0)
        # the accumulators, 4 operations a sample; -i, a gated sample
        # (counted on this input) adds 134 for the buffer and direct taps
        # and 4 fits of about 12, in float32
        flops = 4 * B * C + 182 * gated
        label = "-i" if interp else "plain"
        print(f"  {label}: decisions and state equal, sums within one ulp, over 3 blocks; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        rec["times"].append({"mode": label, "ms": ms, "plain_ms": plain_ms})
        if interp:
            set_times(rec, ms, plain_ms, 4 * B * C + state_bytes, flops, peak=F32_PEAK)
        else:
            prec = records["stats_step_plain_f32"]
            set_times(prec, ms, plain_ms, 4 * B * C + state_bytes, flops, peak=F32_PEAK)
            prec["device_ms"] = device_ms(lambda: td.stats_step_f32(s0, q[0]))[0]
            print(f"  plain: {prec['device_ms']:.4f} ms device-only")
    stats_interp_cases(rec, f32, rng)
    meter_cases(records["stats_step_plain_f32"], records["levels_step_f32"], f32, rng)

    print("K17 levels_step_f32 (B=2048, stereo, 3 blocks)")
    rec = records["levels_step_f32"]
    g = 1.0 - math.exp(-1.0 / (FS * 0.3))
    st = [torch.as_tensor(rng.uniform(0, 0.1, C), dtype=f32, device=dev) for _ in range(3)]
    for blk in range(3):
        x = block()
        out_k = td.levels_step_f32(*st, x, g)
        out_r = td.levels_step_f32_ref(*_to_cpu(st), x.cpu(), g)
        _hold_td32(rec, f"levels_step_f32 block {blk}", (("avg", "peak", "block_peak"), out_k),
                   out_r)
        st = list(out_k)
    ms = cuda_ms(lambda: td.levels_step_f32(*st, x, g), 50)
    plain_ms = cuda_ms(lambda: td.levels_step_f32_ref(*st, x, g), 10)
    # float32 in and out; the scan runs in float64 registers
    set_times(rec, ms, plain_ms, 4 * B * C + 24 * C, 6 * B * C)
    rec["device_ms"] = device_ms(lambda: td.levels_step_f32(*st, x, g))[0]
    print(f"  within one ulp over 3 blocks; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(a chain of {B} samples a channel)")

    print("K14 mod_delay_f32 (0.5 ms depth, 1 kHz modulator, q0/q1/q2, -m and -M, "
          "blocks of 2048, 2048 and 64, stereo; a 0.2 s depth read through L1)")
    rec = records["mod_delay_f32"]
    for qual, mono, samples, _ in (c for c in MOD_DELAY_CASES if c[3] == 1.0):
        e = ModDelayEffect("delay", StreamInfo(FS, C), np.ones(C, dtype=bool), samples, 1000.0,
                           mono, qual, seed=31338)
        st = _f32_state(e, dev)
        table = None if e.table is None else torch.as_tensor(e.table, dtype=f32, device=dev)
        sel = torch.ones(C, dtype=torch.bool, device=dev)
        what = f"mod_delay_f32 q{qual} {'-M' if mono else '-m'} depth {e.depth:g}"
        for blk, Bk in enumerate(MOD_DELAY_BLOCKS):
            xin = torch.as_tensor(rng.standard_normal((Bk, C)) * 0.3, dtype=f32, device=dev)
            args = (st["key"], st["y"], st["t"], st["buf"], xin, sel, table)
            st_k, y_k = mod_delay_step(e, st, xin, td.mod_delay_f32)
            out_k = (st_k["key"], st_k["y"], st_k["t"], y_k, st_k["buf"])
            out_r = td.mod_delay_f32_ref(*_to_cpu(args), e.depth, e.step_size, e.n_taps, qual)
            _hold_td32(rec, f"{what} block {blk}", (("key", "y", "t", "out", "buf"), out_k),
                       out_r, exact=("key", "y", "t", "buf"))
            st = st_k
        if (qual, mono, samples) == (2, True, 0.5e-3 * FS):
            xin = block()
            H = e.len + e.n_taps
            run = (lambda: td.mod_delay_f32(st["key"], st["y"], st["t"], st["buf"], xin, sel,
                                            table, e.depth, e.step_size, e.n_taps, qual))
            ms = cuda_ms(run, 50)
            plain_ms = cuda_ms(lambda: td.mod_delay_f32_ref(
                st["key"], st["y"], st["t"], st["buf"], xin, sel, table, e.depth,
                e.step_size, e.n_taps, qual), 10)
            # x and the line in, y and the line out, the table, float32; the
            # B-spline (~20 float32 operations), 4 x 32 multiply-adds and the
            # join (~15) in float64 a sample
            nbytes = 4 * (2 * B * C + 2 * H * C + table.numel()) + 40
            set_times(rec, ms, plain_ms, nbytes, (20 + 8 * e.n_taps + 15) * B * C)
            rec["device_ms"] = device_ms(run)[0]
            print(f"  q2 -M B={B}: kernel {ms:.4f} ms a call, {rec['device_ms']:.4f} ms "
                  f"device-only, plain {plain_ms:.4f} ms")
    print("  keys, knots, phases and carried lines equal, the reads within one ulp of their "
          "scale; one launch a step")


# slice J3's float32 FFT convolution engines on the main path's shapes:
# (label, engine, taps, block, super-block multiple)
F32_FFT_ENGINES = (
    ("OLS: fir 64k at B=65536", "ols", 1 << 16, 65536, None),
    ("Upols K=32: fir 64k at B=2048", "upols", 1 << 16, 2048, None),
    ("Nupols m=32: fir_p 1M at B=2048", "nupols", 1 << 20, 2048, 32),
    ("OLS: matrix4_mb's 1,306-tap FIR at B=2048", "ols", 1306, 2048, None),
)


def _f32_tree(tree, device):
    """An engine's numpy state0 as float32 tensors on `device`, as a
    float32 CompiledChain holds it (the Nupols block counter stays a CPU
    int32 tensor)."""
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _f32_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree
    return torch.as_tensor(np.asarray(tree), dtype=torch.float32, device=device)


def float32_fft_phase(records):
    """K5-K7 in float32 (slice J3) on the card: rfft_pack_f32 with its head,
    fdl_mac_f32, irfft_crop_f32 with the Nupols addend and splice_f32
    against their plain versions at the Upols shape of fir 64k at
    B = 2048 (N = 4096, K = 32; the spectrum and sums within F32_STATE_REL
    relative, the float32 outputs within one float32 ulp of their scale,
    the shifted FDL and the splice equal), timed with their plain versions
    and torch.fft's float32 transforms; then the engines' float32 steps on
    the card against the same steps' plain versions on the CPU, from the
    same state and input, for each of F32_FFT_ENGINES (a super-block and two
    more blocks for Nupols, so that its tail fires): every output and every
    float32 state leaf within one float32 ulp of its scale, the counter
    equal."""
    import numpy as np
    import torch

    from dsp_tpu_torch.ops import fft_conv as fc

    dev = torch.device("cuda")
    rng = np.random.default_rng(20270)

    def f32(*shape, scale=0.3):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32,
                               device=dev)

    print("K5-K7 in float32: rfft_pack_f32, fdl_mac_f32, irfft_crop_f32, splice_f32 "
          "(Upols at B=2048: N=4096, K=32, stereo)")
    N, C, K, L = 4096, CHANNELS, 32, 2048
    NB = N // 2 + 1
    a, x, add = f32(L, C), f32(L, C), f32(L, C)
    (X_k, kept), X_r = fc.rfft_pack_f32(x, N, a, keep=L), fc.rfft_pack_f32_ref(x, N, a).contiguous()
    H = torch.as_tensor(rng.standard_normal((K, NB, C)) + 1j * rng.standard_normal((K, NB, C)),
                        device=dev)
    fdl = f32(K, NB, C, 2, scale=10.0)
    (Y_k, F_k), (Y_r, F_r) = fc.fdl_mac_f32(X_r, H, fdl), fc.fdl_mac_f32_ref(X_r, H, fdl)
    y_k, y_r = fc.irfft_crop_f32(Y_r, N, L, L, add), fc.irfft_crop_f32_ref(Y_r, N, L, L, add)
    s_k, s_r = fc.splice_f32(a, x, L, 0, L), fc.splice_ref(a, x, L, 0, L)
    torch.cuda.synchronize()
    for name, k_out, r_out in (("rfft_pack_f32", X_k, X_r), ("fdl_mac_f32", Y_k, Y_r)):
        rel = _diff(torch.view_as_real(k_out), torch.view_as_real(r_out)) / float(r_out.abs().max())
        print(f"  {name}: within {rel:.2e} relative")
        _require(f"{name}: {rel:.2e} relative from the plain version", rel <= F32_STATE_REL)
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           _diff(torch.view_as_real(k_out),
                                                 torch.view_as_real(r_out)))
    _require("fdl_mac_f32: the shifted FDL differs from the plain version", torch_equal(F_k, F_r))
    _hold_f32(records["irfft_crop_f32"], "irfft_crop_f32 with the addend", y_k, y_r)
    _require("splice_f32: kernel and plain version differ", torch_equal(s_k, s_r))
    _require("rfft_pack_f32: the kept rows differ from splice_ref",
             torch_equal(kept, fc.splice_ref(a, x, L, 0, L)))
    packed = torch.cat([a, x])
    Y64 = Y_r.to(torch.complex64)
    fft_flops = 2.5 * N * math.log2(N) * C
    timed = {
        # (kernel, plain version, the one torch call (float32, complex64),
        # bytes, operations): a real FFT is ~2.5·N·log2(N) operations a
        # channel; the MAC 8 a partition, bin and channel
        "rfft_pack_f32": (lambda: fc.rfft_pack_f32(x, N, a, keep=L),
                          lambda: fc.rfft_pack_f32_ref(x, N, a),
                          lambda: torch.fft.rfft(packed, n=N, dim=0),
                          4 * 2 * L * C + 16 * NB * C, fft_flops),
        "fdl_mac_f32": (lambda: fc.fdl_mac_f32(X_r, H, fdl),
                        lambda: fc.fdl_mac_f32_ref(X_r, H, fdl),
                        None, NB * C * (16 * 2 + 16 * K + 8 * (K - 1) + 8 * K), 8 * K * NB * C),
        "irfft_crop_f32": (lambda: fc.irfft_crop_f32(Y_r, N, L, L, add),
                           lambda: fc.irfft_crop_f32_ref(Y_r, N, L, L, add),
                           lambda: torch.fft.irfft(Y64, n=N, dim=0)[L:2 * L],
                           16 * NB * C + 2 * 4 * L * C, fft_flops),
        "splice_f32": (lambda: fc.splice_f32(a, x, L, 0, L), lambda: fc.splice_ref(a, x, L, 0, L),
                       lambda: torch.cat([a[L:], x]), 2 * 4 * L * C, 0),
    }
    for name, (kern, plain, lib, nbytes, flops) in timed.items():
        row = timed_row(kern, plain, lib)
        rec = records[name]
        if name == "rfft_pack_f32":  # its record is timed on the resampler's shape
            rec.setdefault("times", []).append({"N": N, "C": C, "keep": L, **row})
        else:
            set_row(rec, row, nbytes, flops)
        print(f"  {name}: {row_text(row)}, bound {bound(nbytes, flops)[0]:.6f} ms")

    print("K5-K7 in float32: the engines' steps on the card against their plain versions")
    for label, kind, taps, B, m in F32_FFT_ENGINES:
        h = rng.standard_normal((C, taps))
        h /= np.sqrt((h * h).sum(axis=1, keepdims=True))
        eng = (fc.OlsConv(h, B) if kind == "ols" else fc.UpolsConv(h, B) if kind == "upols"
               else fc.NupolsConv(h, B, m))
        st_k, st_r = _f32_tree(eng.state0(), dev), _f32_tree(eng.state0(), "cpu")
        xs = f32(((m or 1) + 2) * B, C)
        worst = 0.0
        for b in range(xs.shape[0] // B):
            xb = xs[b * B:(b + 1) * B]
            st_k, y_k = eng.step(st_k, xb)
            st_r, y_r = eng.step(st_r, xb.cpu())
            torch.cuda.synchronize()
            ulps, _ = _ulps(y_k, y_r)
            worst = max(worst, ulps)
            _require(f"{label} block {b}: y {ulps:.2f} ulp of its scale", ulps <= 1.0)
            leaves_k = st_k.values() if isinstance(st_k, dict) else [st_k]
            leaves_r = st_r.values() if isinstance(st_r, dict) else [st_r]
            for lk, lr in zip(leaves_k, leaves_r):
                if isinstance(lk, dict):
                    lk, lr = torch.cat([t.flatten() for t in lk.values()]), \
                        torch.cat([t.flatten() for t in lr.values()])
                if lk.dtype == torch.int32:
                    _require(f"{label}: the block counter differs", torch_equal(lk, lr))
                else:
                    ulps, _ = _ulps(lk, lr)
                    _require(f"{label} block {b}: a state leaf {ulps:.2f} ulp of its scale",
                             ulps <= 1.0)
        print(f"  {label}: {xs.shape[0] // B} blocks, y within {worst:.2f} ulp of its scale, "
              f"the state within one ulp")


# slice J3's float32 upmix checks: (options, rate, block); 1056 = 33 x 32
# takes the band-limit's and the bank's L = 1 plans
M4_F32_CASES = (
    ("matrix4 -6", FS, 2048),
    ("matrix4 matrix=v1 -6", FS, 2048),
    ("matrix4 direct_path -6", FS, 2048),
    ("matrix4 -6", FS, 1056),
    ("matrix4 -6", FS, 65536),
)
MB_F32_CASES = (
    ("matrix4_mb -6", FS, 2048),
    ("matrix4_mb filter_type=butterworth,freq_mask=0.5 -6", FS, 2048),
    ("matrix4_mb -6", 48000, 2048),
    ("matrix4_mb -6", FS, 1056),
    ("matrix4_mb -6", FS, 65536),
    *HIGH_RATE_MB,
)
# the (hi, lo) sums of the float32 engines against their plain versions, as
# each float64 phase holds its engine's floats (matrix4_phase, matrix4_mb_phase)
M4_F32_REL = 1e-12
MB_F32_REL = 1e-13


def _hold_engine(what, out_k, out_r, rel_limit):
    """A float32 engine's results (ev, ev_lo, carry, carry_lo, ics,
    interp_y, aux) against the plain version's: the decisions equal, the
    (hi, lo) sums within rel_limit (relative to max(1, scale)), the
    coefficient sets, window and display within one float32 ulp of their
    scale. Returns (the largest relative error, the largest ulps)."""
    from dsp_tpu_torch.ops import m4_engine as m4

    rel = 0.0
    for k, kind in m4.EV_LEAVES:
        a, b = out_k[0][k], out_r[0][k]
        if kind != "f":
            _require(f"{what}: {k} differs from the plain version", torch_equal(a, b))
        else:
            rel = max(rel, _rel(a.double() + out_k[1][k].double(),
                                b.double() + out_r[1][k].double()))
    rel = max(rel, _rel(out_k[2].double() + out_k[3].double(),
                        out_r[2].double() + out_r[3].double()))
    _require(f"{what}: the (hi, lo) state {rel:.3e} relative from the plain version",
             rel <= rel_limit)
    ulps = 0.0
    for name, a, b in zip(("ics", "interp_y", "aux"), out_k[4:], out_r[4:]):
        u, _ = _ulps(a, b)
        _require(f"{what}: {name} {u:.2f} ulp of its scale from the plain version", u <= 1.0)
        ulps = max(ulps, u)
    return rel, ulps


def float32_m4_phase(records):
    """K9-K13 in float32 (slice J3) on the card: m4_env_f32, m4_event_f32
    and m4_audio_f32 for each case of M4_F32_CASES, m4mb_env_f32,
    m4mb_event_f32 and m4mb_audio_f32 (after K3 on the fshape and K1-df on
    the bank) for each of MB_F32_CASES, against their plain versions on the
    same inputs, over 3 blocks of transients after 2 s of them through the
    float32 chain: the decisions equal, the (hi, lo) state sums within
    M4_F32_REL or MB_F32_REL relative, the envelopes at the ticks
    (float64) within the same, every float32 output within one float32 ulp
    of its scale. Times the kernels and their plain versions at B = 2048
    (v4)."""
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    f32 = torch.float32
    print("K9-K13 in float32 (matrix4): m4_env_f32, m4_event_f32, m4_audio_f32 "
          "(3 blocks after 2 s of transients)")
    for words, fs, B in M4_F32_CASES:
        cc = CompiledChain(build_chain_from_string(words, StreamInfo(fs, CHANNELS)), B, dtype=f32,
                           device="cuda")
        e = cc._runtime_effects[0]
        seconds, blocks = check_blocks(B, fs)
        x = torch.as_tensor(transient_signal(seconds, fs), dtype=f32, device="cuda")
        warm = x.shape[0] // B - blocks
        cc.run_blocks(x[: warm * B].reshape(warm, B, CHANNELS))
        rel = ulps = env_abs = 0.0
        for blk in range(warm, warm + blocks):
            st = cc.states[0]
            xb = x[blk * B:(blk + 1) * B].contiguous()
            _, (hi, lo) = iir.lti_blocked_df(e._bp_plan(B), st["bpc"], xb)
            env_args = (hi, lo, st["env_m"], st["env_m_lo"], e.g_env)
            env_k, env_r = m4.m4_env_f32(*env_args), m4.m4_env_f32_ref(*env_args)
            rel = max(rel, _rel(env_k[2], env_r[2]),
                      _rel(env_k[0].double() + env_k[1].double(),
                           env_r[0].double() + env_r[1].double()))
            env_abs = max(env_abs, _diff(env_k[2], env_r[2]),
                          _diff(env_k[0].double() + env_k[1].double(),
                                env_r[0].double() + env_r[1].double()))
            ins = (e.ctl, {k: v[None] for k, v in st["ev"].items()},
                   {k: v[None] for k, v in st["ev_lo"].items()}, st["bg_cs"][None],
                   st["bg_cs_lo"][None], env_k[2][None], st["interp_y"][None],
                   int(st["fade_p"]), bool(st["disable"]))
            out_k, out_r = m4.m4_event_f32(*ins), m4.m4_event_f32_ref(*ins)
            torch.cuda.synchronize()
            r, u = _hold_engine(f"m4_event_f32 {words} at {fs} block {blk}", out_k, out_r,
                                M4_F32_REL)
            rel, ulps = max(rel, r), max(ulps, u)
            a_ins = (e.audio, xb, st["buf"], st["interp_c"], out_k[4][0], st["shelf_m"],
                     st["lp_m"], st["pf_m"])
            for what, a, b in zip(("y", "shelf_m", "lp_m", "pf_m"), m4.m4_audio_f32(*a_ins),
                                  m4.m4_audio_f32_ref(*a_ins)):
                _hold_f32(records["m4_audio_f32"], f"m4_audio_f32 {words} block {blk} {what}",
                          a, b)
            cc.run_blocks(xb[None])
        ev = cc.states[0]["ev"]
        counters = {k: int(ev[k]) for k in M4_DECISIONS}
        print(f"  {words} at {fs} Hz, B={B}: decisions equal; (hi, lo) sums and envelopes within "
              f"{rel:.3e} relative, ics/window/aux within {ulps:.2f} ulp; after {int(ev['t'])} "
              f"ticks {counters}")
        _require(f"matrix4 {words}: no event in the check's input",
                 counters["diff_count"] + counters["ord_count"] > 0)
        print(f"  m4_env_f32 {words}: ticks and envelopes (hi + lo) within {env_abs:.3e} "
              f"absolute (limit {ENV_ABS})")
        _require(f"m4_env_f32 {words}: {rel:.3e} relative", rel <= M4_F32_REL)
        _require(f"m4_env_f32 {words}: {env_abs:.3e} absolute", env_abs <= ENV_ABS)
        records["m4_env_f32"]["max_abs_err"] = max(records["m4_env_f32"]["max_abs_err"], env_abs)
        records["m4_event_f32"]["max_abs_err"] = max(records["m4_event_f32"]["max_abs_err"], rel)
        if B in (2048, 65536) and fs == FS and words == "matrix4 -6":
            dev_ms = one_launch(f"m4_env_f32 {words} B={B}", lambda: m4.m4_env_f32(*env_args))
            if B == 2048:
                records["m4_env_f32"]["device_ms"] = dev_ms
        if B == 65536:
            set_tick_us(records["m4_event_f32"], B // 32, cuda_ms(lambda: m4.m4_event_f32(*ins), 3))
            dev_ms, _ = device_ms(lambda: m4.m4_audio_f32(*a_ins), 5)
            print(f"  m4_audio_f32 B={B}: kernel "
                  f"{cuda_ms(lambda: m4.m4_audio_f32(*a_ins), 5):.4f} ms, device-only {dev_ms:.4f} ms")
        if (words, fs, B) != M4_F32_CASES[0]:
            continue
        Nc, Lr, n_out = B // 32, e.ctl.p["buf_len"], e.audio.n_out
        st = cc.states[0]
        ins = ins[:-2] + (0, False)
        a_ins = (e.audio, xb, st["buf"], st["interp_c"], out_k[4][0], st["shelf_m"], st["lp_m"],
                 st["pf_m"])
        timed = {
            # the (hi, lo) input and envelope pairs, the ticks out (float64);
            # the hi + lo sum, the input and the EWMA a sample and envelope
            "m4_env_f32": (lambda: m4.m4_env_f32(*env_args), lambda: m4.m4_env_f32_ref(*env_args),
                           16 * B + 128 + 64 * Nc, 8 * 3 * B + 4 * B),
            # the state's pairs in and out (about 80 values and 10 rings of
            # L), the ticks in, the coefficient sets, window and display out
            # in float32; operations as the float64 engine's
            "m4_event_f32": (lambda: m4.m4_event_f32(*ins), lambda: m4.m4_event_f32_ref(*ins),
                             2 * 8 * (80 + 10 * Lr) + 64 * Nc + 4 * Nc * (48 + 4) + 2 * 256,
                             (300 + 250 + 112) * Nc),
            # float32 x, y, line, coefficient sets and states
            "m4_audio_f32": (lambda: m4.m4_audio_f32(*a_ins), lambda: m4.m4_audio_f32_ref(*a_ins),
                             4 * (B * (CHANNELS + n_out) + 2 * e.len + 48 * (Nc + 1) + 32),
                             (40 + 12 + 64 + 10) * B),
        }
        for name, (kern, plain, nbytes, flops) in timed.items():
            ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 2)
            set_times(records[name], ms, plain_ms, nbytes, flops)
            print(f"  {name} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{records[name]['bound_ms']:.6f} ms ({records[name]['bound_by']})")
        print(f"  m4_audio_f32 B={B}: device-only {device_ms(timed['m4_audio_f32'][0])[0]:.4f} ms")
        set_tick_us(records["m4_event_f32"], Nc, records["m4_event_f32"]["ms"])

    print("K1-df, K3, K9-K13 in float32 (matrix4_mb): the fshape, the bank, m4mb_env_f32, "
          "m4mb_event_f32, m4mb_audio_f32 (3 blocks after 2 s of transients)")
    for words, fs, B in MB_F32_CASES:
        e, st = mb_effect(words, fs, B, f32)
        seconds, blocks = check_blocks(B, fs)
        x = torch.as_tensor(transient_signal(seconds, fs), dtype=f32, device="cuda")
        warm = x.shape[0] // B - blocks
        for blk in range(warm):
            st, _ = e.step(st, x[blk * B:(blk + 1) * B].contiguous())
        plan = e._bank_plan(B)
        rel = ulps = env_abs = 0.0
        for blk in range(warm, warm + blocks):
            xb = x[blk * B:(blk + 1) * B].contiguous()
            _, s_pre = e._cascade("fsh", st["fshape_m"].reshape(2, 2, 2), xb)
            _, (hi, lo) = iir.lti_blocked_df(plan, st["bank"]["fused"], s_pre.repeat(1, 13))
            bands, bands_lo = hi.view(B, 13, 2), lo.view(B, 13, 2)
            w = None if e.fmw is None else e.device_array("fmw", xb, torch.float64)
            env_args = (bands, bands_lo, st["env_m"], st["env_m_lo"], e.g_env, w)
            env_k, env_r = m4.m4mb_env_f32(*env_args), m4.m4mb_env_f32_ref(*env_args)
            rel = max(rel, _rel(env_k[2], env_r[2]),
                      _rel(env_k[0].double() + env_k[1].double(),
                           env_r[0].double() + env_r[1].double()))
            env_abs = max(env_abs, _diff(env_k[2], env_r[2]),
                          _diff(env_k[0].double() + env_k[1].double(),
                                env_r[0].double() + env_r[1].double()))
            ins = (e.ctl, st["ev"], st["ev_lo"], st["ev_thresh"], st["ev_thresh_lo"], env_k[2],
                   st["interp_y"], int(st["fade_p"]), bool(st["disable"]))
            out_k, out_r = m4.m4mb_event_f32(*ins), m4.m4mb_event_f32_ref(*ins)
            torch.cuda.synchronize()
            r, u = _hold_engine(f"m4mb_event_f32 {words} at {fs} block {blk}", out_k, out_r,
                                MB_F32_REL)
            rel, ulps = max(rel, r), max(ulps, u)
            a_ins = (e.audio, bands, st["fb_buf"], st["interp_c"], out_k[4], st["pf_m"])
            for what, a, b in zip(("sig", "pf_m"), m4.m4mb_audio_f32(*a_ins),
                                  m4.m4mb_audio_f32_ref(*a_ins)):
                _hold_f32(records["m4mb_audio_f32"], f"m4mb_audio_f32 {words} block {blk} {what}",
                          a, b)
            st, _ = e.step(st, xb)
        ev = st["ev"]
        counters = {k: int(ev[k].sum()) for k in M4_DECISIONS}
        print(f"  {words} at {fs} Hz, B={B} (bank L={plan.L}): decisions equal; (hi, lo) sums and "
              f"envelopes within {rel:.3e} relative, ics/window/aux within {ulps:.2f} ulp; after "
              f"{int(ev['t'][0])} ticks, over the 13 bands {counters}")
        _require(f"matrix4_mb {words}: no event in the check's input",
                 counters["diff_count"] + counters["ord_count"] > 0)
        print(f"  m4mb_env_f32 {words}: ticks and envelopes (hi + lo) within {env_abs:.3e} "
              f"absolute (limit {ENV_ABS})")
        _require(f"m4mb_env_f32 {words}: {rel:.3e} relative", rel <= MB_F32_REL)
        _require(f"m4mb_env_f32 {words}: {env_abs:.3e} absolute", env_abs <= ENV_ABS)
        records["m4mb_env_f32"]["max_abs_err"] = max(records["m4mb_env_f32"]["max_abs_err"],
                                                     env_abs)
        records["m4mb_event_f32"]["max_abs_err"] = max(records["m4mb_event_f32"]["max_abs_err"],
                                                       rel)
        if B == 2048 and fs == FS:
            dev_ms = one_launch(f"m4mb_env_f32 {words} B={B}", lambda: m4.m4mb_env_f32(*env_args))
            if words == "matrix4_mb -6":
                records["m4mb_env_f32"]["device_ms"] = dev_ms
        if fs == FS and words == "matrix4_mb -6":
            mb_audio_launches(records["m4mb_audio_f32"], m4.m4mb_audio_f32, m4.m4mb_audio_f32_ref,
                              e.audio, (bands, st["fb_buf"], st["interp_c"], out_k[4], st["pf_m"]),
                              B, lambda a, b: _ulps(a, b)[0] <= 1.0)
        if B == 65536:
            set_tick_us(records["m4mb_event_f32"], B // 32,
                        cuda_ms(lambda: m4.m4mb_event_f32(*ins), 3))
        if (words, fs, B) != MB_F32_CASES[0]:
            continue
        Nc, Lr, S = B // 32, e.ctl.p["buf_len"], 13
        ins = ins[:-2] + (0, False)
        a_ins = (e.audio, bands, st["fb_buf"], st["interp_c"], out_k[4], st["pf_m"])
        timed = {
            "m4mb_env_f32": (lambda: m4.m4mb_env_f32(*env_args),
                             lambda: m4.m4mb_env_f32_ref(*env_args),
                             8 * (2 * B * S + 2 * 8 * S + 8 * Nc * S), 8 * 3 * B * S + 4 * B * S),
            "m4mb_event_f32": (lambda: m4.m4mb_event_f32(*ins),
                               lambda: m4.m4mb_event_f32_ref(*ins),
                               8 * (2 * S * (80 + 10 * Lr) + 2 * S + 8 * Nc * S)
                               + 4 * (3 * Nc * S * 12 + 2 * 4 * S * 12 + 2 * Nc * S),
                               (300 + 156 + 250) * S * Nc + 7 * S * 12 * Nc),
            "m4mb_audio_f32": (lambda: m4.m4mb_audio_f32(*a_ins),
                               lambda: m4.m4mb_audio_f32_ref(*a_ins),
                               4 * (2 * B * S + 2 * min(B, e.fb_buf_len) * S
                                    + 3 * (Nc + 1) * S * 12 + 2 * 4 * S + 4 * B),
                               (48 + 12 + 10 + 6) * S * B),
        }
        for name, (kern, plain, nbytes, flops) in timed.items():
            ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 2)
            set_times(records[name], ms, plain_ms, nbytes, flops)
            print(f"  {name} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{records[name]['bound_ms']:.6f} ms ({records[name]['bound_by']})")
        set_tick_us(records["m4mb_event_f32"], Nc, records["m4mb_event_f32"]["ms"])


REPLAY_SECONDS = 10
# matrix4_mb's float32 audio path on the main input against the plain
# float64 run: the coefficient sets are float32 (dsp_tpu's layout), and
# rounding only them (the phase-flip allpass's coefficient near -1 meets
# the 55 Hz tone) moves the output by as much as the float32 path's whole
# difference (-118.4 dBFS on an NVIDIA H100 80GB HBM3, 700 W). The replay
# shows it in every run: a float64 audio path fed the float32-rounded
# inputs (the witness) is printed against the plain float64 run, and the
# float32 path is held to F32_LIMIT_DBFS against the witness; against the
# plain run only to this bound there, to F32_LIMIT_DBFS everywhere else
MB_F32_REPLAY_DBFS = -110.0


def control_split_signal(seconds, fs=FS):
    """tests/test_f32_accuracy.py's control-split signal: a 440 Hz tone on
    both channels (0.4 rad apart), a 97 Hz tone on the left and a
    Hann-windowed noise burst on the right."""
    import numpy as np

    n = int(seconds * fs)
    rng = np.random.default_rng(1)
    t = np.arange(n) / fs
    x = np.zeros((n, 2))
    x[:, 0] = 0.35 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 97 * t)
    x[:, 1] = (0.35 * np.sin(2 * np.pi * 440 * t + 0.4)
               + 0.1 * rng.standard_normal(n) * np.hanning(n))
    return x


def float32_control_replay(src):
    """The float32 audio paths under float64 control, on the card (dsp_tpu
    holds its float32 upmixes the same way, tests/test_f32_accuracy.py):
    each upmix effect runs float64 _control and _audio, and its float32
    _audio replays that control (the coefficient sets, and matrix4_mb's
    bands, rounded to float32) on the float32 input. A float64 _audio fed
    the same rounded inputs (the witness) isolates the audio path's own
    precision: the float32 output within F32_LIMIT_DBFS of the witness,
    and of the plain float64 output, on REPLAY_SECONDS of the control
    split's signal and of the main path's input (src), matrix4_mb's on the
    latter within MB_F32_REPLAY_DBFS of the plain float64 output."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    B = 2048
    inputs = (("the control split's signal", control_split_signal(REPLAY_SECONDS)),
              ("the main input", read_wav(src, REPLAY_SECONDS * FS)[1]))
    print(f"float32 audio paths under float64 control, {REPLAY_SECONDS} s")
    for what, x in inputs:
        n = len(x) // B
        xs = torch.as_tensor(x[: n * B], device="cuda")
        for words in (MATRIX4, MATRIX4_MB):
            runs = {}
            for dtype in (torch.float64, torch.float32):
                cc = CompiledChain(build_chain_from_string(words, StreamInfo(FS, CHANNELS)), B,
                                   dtype=dtype, device="cuda")
                i = next(i for i, e in enumerate(cc._runtime_effects)
                         if type(e).__name__.startswith("Matrix4"))
                runs[dtype] = [cc._runtime_effects[i], cc.states[i]]
            (e64, s64), (e32, s32) = runs[torch.float64], runs[torch.float32]
            sw = s64  # the witness: float64 _audio on the float32-rounded inputs
            worst = {"float64": 0.0, "witness": 0.0, "witness-float64": 0.0}
            for b in range(n):
                xb = xs[b * B:(b + 1) * B]
                ctl = e64._control(s64, xb)
                s64, y64 = e64._audio(s64, xb, ctl)
                pinned = {k: ctl[k].float() for k in ("ics", "bands") if k in ctl}
                s32, y32 = e32._audio(s32, xb.float(), dict(pinned, aux=s32["aux"]))
                sw, yw = e64._audio(sw, xb.float().double(), dict(
                    ctl, **{k: v.double() for k, v in pinned.items()}))
                for key, (a, c) in (("float64", (y32.double(), y64)),
                                    ("witness", (y32.double(), yw)),
                                    ("witness-float64", (yw, y64))):
                    worst[key] = max(worst[key], float((a - c).abs().max()))
            limit = (MB_F32_REPLAY_DBFS if (words, what) == (MATRIX4_MB, "the main input")
                     else F32_LIMIT_DBFS)
            _require(f"{words}: the float32 audio path replay gave non-finite output",
                     all(np.isfinite(v) for v in worst.values()))
            print(f"  {words} on {what}: the float32 audio path under the float64 control: "
                  f"max |diff| {worst['float64']:.3e} ({dbfs(worst['float64']):.1f} dBFS, "
                  f"limit {limit}); against the witness {worst['witness']:.3e} "
                  f"({dbfs(worst['witness']):.1f} dBFS, limit {F32_LIMIT_DBFS}); the witness "
                  f"against float64 {dbfs(worst['witness-float64']):.1f} dBFS")
            _require(f"{words} on {what}: float32 audio path {dbfs(worst['float64']):.1f} dBFS "
                     f"from float64", dbfs(worst["float64"]) <= limit)
            _require(f"{words} on {what}: float32 audio path {dbfs(worst['witness']):.1f} dBFS "
                     f"from the witness", dbfs(worst["witness"]) <= F32_LIMIT_DBFS)


def float32_phase(records, tmp, kept):
    """The float32 mode (slices J1 to J3) on the card. Its kernels against
    their plain versions, on the same inputs: K1-df (lti_blocked_f32) on the flagship cascade
    (C = 2, n = 12) at B = 2048 and 65536 and on matrix4_mb's bank (C = 26,
    n = 40, L = 128) at B = 2048 with its (hi, lo) output; K3
    (biquad_scan_df) on the flagship's 30 Hz highpass (coupled form, 2
    lanes) at B = 1000 and 100; K2 in float32 (biquad_scan_f32) on
    crossfeed's 4 lanes at B = 1000 and 2048; a (hi, lo) state handed from
    K1-df to K3 and back; the float32 resampler step (rfft_pack_f32,
    resample_fold, irfft_ola_f32) from 44.1 to 48 and 192 kHz, and
    irfft_ola_f32 on plans of two passes (N = 11760, 2·8221). float32
    outputs within one float32 ulp of the output scale, (hi, lo) sums
    within F32_STATE_REL. Times each kernel and its plain version. Then
    slice J3's: K5-K7 in float32 (float32_fft_phase), the upmixes' K9-K13 in
    float32 (float32_m4_phase) and their float32 audio paths under float64
    control (float32_control_replay). Then the float32 CLI runs
    (float32_cli) on the main path's input in tmp, against the float64
    renders main_path kept (kept)."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops.fft_conv import fft_plan, rfft_pack_f32, rfft_pack_f32_ref
    from dsp_tpu_torch.ops.resample_ops import (SpectralResampler, irfft_ola_f32,
                                                irfft_ola_f32_ref, resample_fold_ref)

    dev = torch.device("cuda")
    rng = np.random.default_rng(20267)
    plan, _ = flagship_parts()
    bank = mb_effect(MATRIX4_MB, FS, 2048)[0]._bank_plan(2048)
    effects = build_chain_from_string(FLAGSHIP, StreamInfo(FS, CHANNELS)).effects
    hp = next(e for e in effects if e.name == "highpass")
    cf = next(e for e in effects if e.name == "crossfeed")

    def f32(*shape, scale=0.3):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32,
                               device=dev)

    def pair(*shape):
        return torch.stack(iir.split_f64(torch.as_tensor(rng.standard_normal(shape) * 1e-2,
                                                         device=dev)))

    bank1 = mb_effect(MATRIX4_MB, FS, 1056)[0]._bank_plan(1056)
    m4e = build_chain_from_string(MATRIX4, StreamInfo(FS, CHANNELS)).effects[0]
    rec = records["lti_blocked_f32"]
    print("K1-df lti_blocked_f32 (float32 samples and (hi, lo) state, float64 inside)")
    for label, pl, B, df in (("flagship cascade", plan, 2048, False),
                             ("flagship cascade", plan, 65536, False),
                             ("matrix4_mb's bank, (hi, lo) out", bank, 2048, True),
                             ("matrix4_mb's bank at L = 1, (hi, lo) out", bank1, 1056, True),
                             ("matrix4's band-limit, (hi, lo) out", m4e._bp_plan(2048), 2048,
                              True),
                             ("matrix4's band-limit at L = 1, (hi, lo) out", m4e._bp_plan(1000),
                              1000, True)):
        x, st = f32(B, pl.C), pair(pl.C, pl.n)
        s_k, y_k = iir.lti_blocked_f32(pl, st, x, df)
        s_r, y_r = iir.lti_blocked_f32_ref(pl, st, x, df)
        torch.cuda.synchronize()
        what = f"{label} C={pl.C} n={pl.n} B={B}"
        _hold_f32(rec, what, y_k[0] if df else y_k, y_r[0] if df else y_r, s_k, s_r)
        if df:
            rel = _pair_rel(y_k, y_r)
            print(f"  {what}: y hi + lo within {rel:.2e} relative")
            _require(f"{what}: y hi + lo {rel:.2e} relative from the plain version",
                     rel <= F32_STATE_REL)
        dev_ms = one_launch(f"K1-df {what}", lambda: iir.lti_blocked_f32(pl, st, x, df))
        if pl is plan and B == 2048:
            rec["device_ms"] = dev_ms
        if (pl is plan and B == 2048) or df:
            ms = cuda_ms(lambda: iir.lti_blocked_f32(pl, st, x, df), 50)
            plain_ms = cuda_ms(lambda: iir.lti_blocked_f32_ref(pl, st, x, df), 5)
            print(f"  {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            rec.setdefault("times", []).append({"C": pl.C, "n": pl.n, "B": B, "ms": ms,
                                                "plain_ms": plain_ms})
            if pl is plan:
                # float32 x and y, the float32 state pair in and out, the
                # float64 tables h, V, P, A^L, c0; K1's operations
                n, C, L = pl.n, pl.C, pl.L
                nbytes = 4 * (2 * B * C + 4 * C * n) + 8 * (C * L + 2 * C * n * L + C * n * n + C)
                flops = 2 * C * (B // L) * (L * (L - 1) // 2 + 2 * n * L + n * n) + 2 * B * C
                set_times(rec, ms, plain_ms, nbytes, flops)

    rec = records["biquad_scan_df"]
    print("K3 biquad_scan_df (flagship's highpass 30, coupled form, 2 lanes)")
    A, Bv, c0 = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (hp._ss_A, hp._ss_Bv, hp._ss_c0))
    for B in (1000, 100):
        x, st = f32(B, CHANNELS), pair(CHANNELS, 2)
        s_k, y_k = iir.biquad_scan_df(A, Bv, c0, st, x)
        s_r, y_r = iir.biquad_scan_df_ref(A, Bv, c0, st, x)
        torch.cuda.synchronize()
        _hold_f32(rec, f"B={B}", y_k, y_r, s_k, s_r)
        if B == 1000:
            ms = cuda_ms(lambda: iir.biquad_scan_df(A, Bv, c0, st, x), 50)
            plain_ms = cuda_ms(lambda: iir.biquad_scan_df_ref(A, Bv, c0, st, x), 5)
            print(f"  B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            # float32 x and y and state pairs, float64 A, Bv, c0; 10
            # float64 operations a sample and lane
            C = CHANNELS
            set_times(rec, ms, plain_ms, 4 * (2 * B * C + 8 * C) + 8 * 7 * C, 10 * B * C)
    # the single float32 state matrix4_mb's fshape (2 lanes) and its inverse
    # (4 lanes) hand in and out, a stage at a time
    for C in (2, 4):
        Ac, Bc, cc = A.repeat(C // 2, 1, 1), Bv.repeat(C // 2, 1), c0.repeat(C // 2)
        x, st = f32(2048, C), f32(C, 2, scale=1e-2)
        s_k, y_k = iir.biquad_scan_df(Ac, Bc, cc, st, x)
        s_r, y_r = iir.biquad_scan_df_ref(Ac, Bc, cc, st, x)
        torch.cuda.synchronize()
        _hold_f32(rec, f"single state, B=2048, C={C}: y", y_k, y_r)
        _hold_f32(rec, f"single state, B=2048, C={C}: the end state", s_k, s_r)

    print("K1-df -> K3 -> K1-df: the highpass's (hi, lo) state handed over (2048, 1000, 2048)")
    hp_plan = iir.BiquadBlockedPlan(hp.c)
    x = f32(5096, CHANNELS)
    parts = ((0, 2048), (2048, 3048), (3048, 5096))
    ys = {}
    for side, k1, k3 in (("kernel", iir.lti_blocked_f32, iir.biquad_scan_df),
                         ("plain", iir.lti_blocked_f32_ref, iir.biquad_scan_df_ref)):
        st = torch.zeros((2, CHANNELS, 2), dtype=torch.float32, device=dev)
        out = []
        for i, (a, b) in enumerate(parts):
            st, y = k1(hp_plan, st, x[a:b]) if i != 1 else k3(A, Bv, c0, st, x[a:b])
            out.append(y)
        ys[side] = (torch.cat(out), st)
    torch.cuda.synchronize()
    _hold_f32(rec, "handover", ys["kernel"][0], ys["plain"][0], ys["kernel"][1], ys["plain"][1])
    st64 = torch.zeros((CHANNELS, 2), dtype=torch.float64, device=dev)
    _, y64 = iir.biquad_scan_ref(A, Bv, c0, st64, x.double())
    err = _diff(ys["kernel"][0].double(), y64)
    print(f"  handover against one float64 run: {dbfs(err):.1f} dBFS")
    _require(f"handover: {dbfs(err):.1f} dBFS against one float64 run",
             dbfs(err) <= F32_LIMIT_DBFS)

    rec = records["biquad_scan_f32"]
    print("K2 biquad_scan_f32 (crossfeed, companion form in float32, 4 lanes)")
    A, Bv, c0 = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (cf._ss32_A, cf._ss32_Bv, cf._ss32_c0))
    for B in (1000, 2048):
        x, st = f32(B, 4), f32(4, 2, scale=1e-2)
        s_k, y_k = iir.biquad_scan_f32(A, Bv, c0, st, x)
        s_r, y_r = iir.biquad_scan_f32_ref(A, Bv, c0, st, x)
        torch.cuda.synchronize()
        _hold_f32(rec, f"B={B}", y_k, y_r)
        _hold_f32(rec, f"B={B} end state", s_k, s_r)
        if B == 2048:
            ms = cuda_ms(lambda: iir.biquad_scan_f32(A, Bv, c0, st, x), 50)
            plain_ms = cuda_ms(lambda: iir.biquad_scan_f32_ref(A, Bv, c0, st, x), 5)
            print(f"  B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            # x and y, the state in and out, A, Bv, c0, all float32; 10
            # float32 operations a sample and lane
            set_times(rec, ms, plain_ms, 4 * (2 * B * 4 + 4 * 4 + 7 * 4), 10 * B * 4,
                      peak=F32_PEAK)

    print("K8-df, K19's FFT: rfft_pack_f32, resample_fold, irfft_ola_f32 "
          "(4 inner blocks, stereo)")
    for out_fs in (48000, 192000):
        rs = SpectralResampler(FS, out_fs)
        n, ncol = 4, 4 * CHANNELS
        x, ov = f32(n * rs.in_len, CHANNELS), f32(rs.out_len, CHANNELS, scale=0.1)
        ov_k, y_k = rs.block(ov, x)
        ov_r, y_r = rs.block(ov.cpu(), x.cpu())
        cols = x.reshape(n, rs.in_len, CHANNELS).permute(1, 0, 2).reshape(rs.in_len, ncol)
        N_in, N_out = 2 * rs.in_len, 2 * rs.out_len
        X_k = rfft_pack_f32(x, N_in, blocks=n)  # the inner blocks read in place
        X_r = rfft_pack_f32_ref(cols, N_in).contiguous()
        Y = resample_fold_ref(X_r, rs.fold).contiguous()
        ratio = rs.out_len / rs.in_len
        o_k, o_r = irfft_ola_f32(Y, N_out, ov, ratio), irfft_ola_f32_ref(Y, N_out, ov, ratio)
        torch.cuda.synchronize()
        x_rel = _diff(torch.view_as_real(X_k), torch.view_as_real(X_r)) / float(X_r.abs().max())
        print(f"  {FS} -> {out_fs}: rfft_pack_f32 within {x_rel:.2e} relative")
        _require(f"rfft_pack_f32 {out_fs}: {x_rel:.2e} relative", x_rel <= 1e-13)
        records["rfft_pack_f32"]["max_abs_err"] = max(
            records["rfft_pack_f32"]["max_abs_err"],
            _diff(torch.view_as_real(X_k), torch.view_as_real(X_r)))
        _hold_f32(records["irfft_ola_f32"], f"{out_fs} irfft_ola_f32 y", o_k[1], o_r[1])
        _hold_f32(records["irfft_ola_f32"], f"{out_fs} irfft_ola_f32 overlap", o_k[0], o_r[0])
        _hold_f32(records["irfft_ola_f32"], f"{out_fs} whole step y", y_k, y_r)
        _hold_f32(records["irfft_ola_f32"], f"{out_fs} whole step overlap", ov_k, ov_r)
        times = {
            "rfft_pack_f32": (lambda: rfft_pack_f32(x, N_in, blocks=n),
                              lambda: rfft_pack_f32_ref(x, N_in, blocks=n),
                              # the one torch call: cuFFT's rfft of the float32
                              # columns (complex64, so less exact)
                              lambda: torch.fft.rfft(cols, n=N_in, dim=0)),
            "irfft_ola_f32": (lambda: irfft_ola_f32(Y, N_out, ov, ratio),
                              lambda: irfft_ola_f32_ref(Y, N_out, ov, ratio), None),
        }
        step_ms = cuda_ms(lambda: rs.block(ov, x), 20)
        fft_in, fft_out = (2.5 * N * math.log2(N) * ncol for N in (N_in, N_out))
        io = {"rfft_pack_f32": (4 * rs.in_len * ncol + 16 * (rs.in_len + 1) * ncol, fft_in),
              "irfft_ola_f32": (16 * (rs.out_len + 1) * ncol + 4 * rs.out_len * (ncol + 2 * CHANNELS),
                                fft_out + 3 * rs.out_len * ncol)}
        step_dev, step_kernels = device_ms(lambda: rs.block(ov, x))
        for name, (kern, plain, lib) in times.items():
            row = timed_row(kern, plain, lib)
            launched = fft_kernels(kern)
            print(f"  {out_fs} {name}: {row_text(row)}; {launched} launched a call; the whole "
                  f"float32 step {step_ms:.4f} ms a call, {step_dev:.4f} ms device-only, "
                  f"{step_kernels} kernels")
            require_kernels(f"{name} {out_fs}", launched, 1)
            records[name].setdefault("times", []).append(
                {"out_fs": out_fs, **row, "step_ms": step_ms, "step_device_ms": step_dev,
                 "step_kernels": step_kernels})
            if out_fs == 48000:
                set_row(records[name], row, *io[name])
    # the inverse of a resampler whose N is above 8192 (7-smooth: the
    # four-step split) or has a prime above 8192 (a global pass): a plan of
    # two passes stores the scaled inverse, then ola_f32_kernel adds
    print("irfft_ola_f32 on plans of two passes (4 inner blocks, stereo)")
    for N in (11760, 2 * 8221):
        ncol, ratio = 4 * CHANNELS, 0.9
        ola_plan = fft_plan(N, ncol, ola=True)
        Y = torch.fft.rfft(torch.as_tensor(rng.standard_normal((N, ncol)) * 0.3, device=dev),
                           dim=0).contiguous()
        ov = f32(N // 2, CHANNELS, scale=0.1)
        o_k, o_r = irfft_ola_f32(Y, N, ov, ratio), irfft_ola_f32_ref(Y, N, ov, ratio)
        torch.cuda.synchronize()
        radices = " | ".join(",".join(map(str, p.radices)) for p in ola_plan.passes)
        what = f"N={N} ({ola_plan.path}: {radices})"
        _hold_f32(records["irfft_ola_f32"], f"{what} y", o_k[1], o_r[1])
        _hold_f32(records["irfft_ola_f32"], f"{what} overlap", o_k[0], o_r[0])
        # the plan's passes, then the overlap-add
        launched = fft_kernels(lambda: irfft_ola_f32(Y, N, ov, ratio))
        print(f"  {what}: {launched} kernels launched a call")
        require_kernels(f"irfft_ola_f32 {what}", launched, len(ola_plan.passes) + 1)
    float32_fft_phase(records)
    float32_m4_phase(records)
    float32_control_replay(tmp / "in.wav")
    float32_cli(records, tmp, kept)


# matrix4_mb's free run from the stream's start: its engines flip decisions
# under any rounding where a band sits at crosstalk level (PARITY.md:192-214:
# rounding only the input to float32 moves the band matrices by up to 0.124;
# dsp_tpu's float32 free run on the TPU: -29 dBFS). Its first MB_ONSET[0] s
# against the float64 render are held only to MB_F32_FREE_DBFS, which
# catches a gross fault (measured on an NVIDIA H100 80GB HBM3, 700 W, a
# second at a time: -36.7, -66.0, -98.8, -100.5 dBFS; the CPU: -36.8 in the
# first 0.1 s); the rest of the run to MB_F32_LATE_DBFS, dsp_tpu's own bound
# on its float32 free run (tests/test_f32_accuracy.py; measured there
# -100.2 dBFS on the same card)
MB_F32_FREE_DBFS = -20.0
MB_F32_LATE_DBFS = -95.0


def float32_cli(records, tmp, kept):
    """DSP_TPU_TORCH_DTYPE=float32 dsp-torch on the main path's 300 s input
    (tmp/in.wav, written by main_path) for each of F32_RUNS and slice J3's
    chains (matrix4 -6, matrix4_mb -6, fir 64k at blocks 65536 and 2048,
    fir_p 1M at 2048), and on its 60 s input (tmp/in60.wav) `resample 44101`
    (the resampler's route of three launches), held against the same chain's float64 render on the
    card: the one main_path kept where it kept one (kept, {(chain, block):
    path}), else a float64 run here. Exact frame counts, the float32 run's
    kernels launched and no float64 kernel, the two within F32_LIMIT_DBFS
    on the whole run; matrix4_mb's free run within MB_F32_LATE_DBFS from
    MB_ONSET[0] s on and within MB_F32_FREE_DBFS before, its difference
    printed a second at a time for the first 10 s. Prints the measured dBFS
    and the runs' x realtime."""
    import contextlib
    import io
    import os

    import numpy as np

    from dsp_tpu_torch.chain import build_chain_from_args
    from dsp_tpu_torch.chain.chain import expected_out_frames
    from dsp_tpu_torch.cli.main import main as cli_main
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops import fft_conv, iir, resample_ops
    from dsp_tpu_torch.ops import m4_engine as m4

    src = tmp / "in.wav"
    f32w = {"lti_blocked_f32": iir.lti_blocked_f32, "biquad_scan_df": iir.biquad_scan_df,
            "biquad_scan_run_df": iir.biquad_scan_run_df,
            "biquad_scan_f32": iir.biquad_scan_f32, "crossfeed_step_f32": iir.crossfeed_step_f32,
            "rfft_pack_f32": fft_conv.rfft_pack_f32,
            "resample_step_f32": resample_ops.resample_step_f32,
            "resample_fold": resample_ops.resample_fold,
            "irfft_ola_f32": resample_ops.irfft_ola_f32, "fdl_mac_f32": fft_conv.fdl_mac_f32,
            "irfft_crop_f32": fft_conv.irfft_crop_f32, "splice_f32": fft_conv.splice_f32,
            **{f"{name}_f32": getattr(m4, f"{name}_f32") for name in (
                "m4_env", "m4_event", "m4_audio", "m4mb_env", "m4mb_event", "m4mb_audio")}}
    f64w = {"lti_blocked": iir.lti_blocked, "biquad_scan": iir.biquad_scan,
            **{name: getattr(iir, name) for name in (
                "crossfeed_step", "biquad_scan_series", "biquad_scan_pair", "biquad_scan_run")},
            **{name: getattr(fft_conv, name) for name in (
                "rfft_pack", "fdl_mac", "irfft_crop", "splice")},
            "resample_step": resample_ops.resample_step, "irfft_ola": resample_ops.irfft_ola,
            **{name: getattr(m4, name) for name in (
                "m4_env", "m4_event", "m4_audio", "m4mb_env", "m4mb_event", "m4mb_audio")}}
    # the engines' carried input comes out of rfft_pack_f32; only the
    # Nupols stage write (and matrix4_mb's lookahead line) splice
    fft = ("rfft_pack_f32", "fdl_mac_f32", "irfft_crop_f32")
    f64k, f1m = ["fir", str(tmp / "f64k.wav")], ["fir_p", str(tmp / "f1m.wav")]
    # (label, words, block, the float32 kernels it must launch, the key of
    # main_path's float64 render or None)
    runs = [(f"{'flagship' if words == FLAGSHIP else words} -b {block}", words.split(), block,
             {(FLAGSHIP, 2048): ("lti_blocked_f32", "crossfeed_step_f32"),
              (FLAGSHIP, 1000): ("biquad_scan_run_df", "crossfeed_step_f32"),
              ("resample 48k", 2048): ("resample_step_f32",)}[words, block],
             (words, block)) for words, block in F32_RUNS]
    runs += [
        ("matrix4 -6 -b 2048", MATRIX4.split(), 2048,
         ("lti_blocked_f32", "m4_env_f32", "m4_event_f32", "m4_audio_f32", "splice_f32"),
         (MATRIX4, 2048)),
        ("matrix4_mb -6 -b 2048", MATRIX4_MB.split(), 2048,
         fft + ("splice_f32", "biquad_scan_run_df", "lti_blocked_f32", "m4mb_env_f32",
                "m4mb_event_f32", "m4mb_audio_f32"), (MATRIX4_MB, 2048)),
        (f"{LONE_BIQUAD} -b 1000", LONE_BIQUAD.split(), 1000, ("biquad_scan_df",),
         (LONE_BIQUAD, 1000)),
        ("fir 64k -b 65536 (OLS)", f64k, 65536, fft, ("fir 64k", 65536)),
        ("fir 64k -b 2048 (Upols, K = 32)", f64k, 2048, fft, ("fir 64k", 2048)),
        ("fir_p 1M -b 2048 (Nupols, m = 32)", f1m, 2048, fft + ("splice_f32",),
         ("fir_p 1M", 2048)),
        # the resampler's route of three launches, on main_path's 60 s input
        ("resample 44101 (the route of three launches)", ["resample", "44101"], 2048,
         ("rfft_pack_f32", "resample_fold", "irfft_ola_f32"), None),
    ]
    inputs = {"resample 44101 (the route of three launches)": (tmp / "in60.wav", 60)}
    print(f"float32 mode: dsp-torch on {SECONDS} s (60 s where named), float32 against float64 "
          f"on the card")
    for label, words, block, expect, key in runs:
        src_i, secs = inputs.get(label, (src, SECONDS))
        chain = build_chain_from_args(words, StreamInfo(FS, CHANNELS))
        want = expected_out_frames(chain, secs * FS) - chain.output_discard
        walls, ys = {}, {}
        for dtype in ("float64", "float32"):
            if dtype == "float64" and key in kept:
                ys[dtype] = read_wav(kept.pop(key))
                continue
            out = tmp / f"out_{dtype}.wav"
            argv = (["-b", str(block)] if block != 2048 else []) + [
                "-q", str(src_i), "-o", "-e", "double", str(out), *words]
            for w in (*f32w.values(), *f64w.values()):
                w.launches = 0
            os.environ["DSP_TPU_TORCH_DTYPE"] = dtype
            err = io.StringIO()
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stderr(err):
                    rc = cli_main(argv)
                walls[dtype] = time.perf_counter() - t0
            finally:
                os.environ.pop("DSP_TPU_TORCH_DTYPE")
            if rc != 0:
                raise SmokeError(f"{label} {dtype}: dsp-torch exited {rc}: {err.getvalue()[-2000:]}")
            if dtype == "float32":
                counts = {name: f32w[name].launches for name in expect}
                stray = {name: w.launches for name, w in f64w.items() if w.launches}
                print(f"  {label}: float32 launches {counts}")
                _require(f"{label}: a float32 kernel was not launched: {counts}",
                         all(c > 0 for c in counts.values()))
                _require(f"{label}: float64 kernels ran in the float32 chain: {stray}", not stray)
                for name, c in counts.items():
                    records[name]["launches"] += c
            ys[dtype] = read_wav(out)
            out.unlink()
        for dtype, (got, _) in ys.items():
            _require(f"{label} {dtype}: {got} output frames, expected {want}", got == want)
        y32, y64 = ys["float32"][1], ys["float64"][1]
        if not np.isfinite(y32).all():
            raise SmokeError(f"{label}: non-finite float32 output")
        diff = float(np.abs(y32 - y64).max())
        wall64 = (f"float64 {walls['float64']:.3f} s, {secs / walls['float64']:.1f}x"
                  if "float64" in walls else "float64 kept from the main path")
        print(f"  {label}: float32 {walls['float32']:.3f} s wall, "
              f"{secs / walls['float32']:.1f}x realtime; {wall64}; float32 against float64 on "
              f"all {secs} s: max |diff| {diff:.3e} ({dbfs(diff):.1f} dBFS)")
        limit = F32_LIMIT_DBFS
        if key == (MATRIX4_MB, 2048):
            per_s = [float(np.abs(y32[i:i + FS] - y64[i:i + FS]).max())
                     for i in range(0, COMPARE_SECONDS * FS, FS)]
            n0 = int(MB_ONSET[0] * FS)
            late = float(np.abs(y32[n0:] - y64[n0:]).max(initial=0.0))
            print(f"  {label}: the free run against float64, a second at a time (dBFS): "
                  + " ".join(f"{dbfs(e):.1f}" for e in per_s)
                  + f"; after {MB_ONSET[0]:g} s {dbfs(late):.1f} (limit {MB_F32_LATE_DBFS})")
            _require(f"{label}: float32 {dbfs(late):.1f} dBFS from float64 after "
                     f"{MB_ONSET[0]:g} s (limit {MB_F32_LATE_DBFS})", dbfs(late) <= MB_F32_LATE_DBFS)
            diff = float(np.abs(y32[:n0] - y64[:n0]).max())
            limit = MB_F32_FREE_DBFS
        _require(f"{label}: float32 {dbfs(diff):.1f} dBFS from float64 (limit {limit})",
                 dbfs(diff) <= limit)
    for path in kept.values():  # renders no float32 run asked for
        path.unlink(missing_ok=True)


# slice J4's float32 runs of slice C's chains (float32_time_domain_cli): the
# table's levels of the float32 run against the float64 run of the same
# 300 s, whose dither, noise and modulator are other draws (jax's float32
# uniform draws other numbers than its float64 one): RMS and peak in dB, DC
# offset absolute. The modulated chain's peak moves with its modulator's
# draws (measured 0.025 dB on 6 s on the CPU), the delivery chain's only
# with its dither's (0.002 dB)
F32_TABLE_DB = 0.01
F32_TABLE_PEAK_DB = {"delivery": 0.01, "modulated": 0.1}
F32_TABLE_DC = 1e-6


def _table_rows(table):
    """A stats table as {row label: [value per channel]}."""
    return {line[:18].strip(): [float(v) for v in line[18:].split()]
            for line in table.splitlines() if line.strip()}


def float32_time_domain_refs(tmp):
    """float32_time_domain_cli's CPU runs, submitted to workers of their own
    (CpuReferences) as soon as the main path has written its input, so that
    they run beside the phases between: the float32 references of the
    delivery and modulated chains and their float32 stats tables."""
    _, head = read_wav(tmp / "in.wav", COMPARE_SECONDS * FS)
    refs = CpuReferences(4)
    for words, enc in ((DELIVERY, "s16"), (MODULATED, "double")):
        refs.submit(words.split(), 2048, head, enc=enc, seed=SLICE_C_SEED, dtype="float32")
    refs.submit_tables(head, tmp, dtype="float32")
    return refs


def float32_time_domain_cli(records, tmp, refs=None):
    """DSP_TPU_TORCH_DTYPE=float32 dsp-torch on the main path's 300 s input
    (tmp/in.wav) for slice C's two chains at block 2048: the delivery chain
    to s16 and the modulated chain to double. Each run must write the
    expected frame count, launch the float32 kernels of its effects and no
    float64 one (counts zeroed just before the run), and match the port's
    float32 run on the CPU on the first COMPARE_SECONDS: the s16 samples
    equal (delivery), within one float32 ulp of full scale (modulated); the
    delivery chain's stats table from a card run and a CPU run of the CLI on
    those seconds equal character for character. On the whole run, held
    against the float64 render main_path kept (tmp/f64_delivery.wav,
    tmp/f64_modulated.wav, and their stats tables) by what does not depend
    on the draws: the stats table's DC offset within F32_TABLE_DC, its RMS
    level within F32_TABLE_DB and its peak within F32_TABLE_PEAK_DB; the RMS of the float32 output minus
    the float64 one is printed beside the level that the noise and dither
    settings predict for two independent draws (the modulated chain's
    difference is larger: its modulator's other draws move the delay).
    The CPU runs come from refs (float32_time_domain_refs) where it has
    them."""
    import os

    import numpy as np

    from dsp_tpu_torch.ops import fft_conv, iir
    from dsp_tpu_torch.ops import time_domain as td

    src = tmp / "in.wav"
    n_in = SECONDS * FS
    _, head = read_wav(src, COMPARE_SECONDS * FS)
    f64w = {"biquad_scan": iir.biquad_scan, "splice": fft_conv.splice,
            **{name: getattr(td, name) for name in (
                "tpdf_noise", "tpdf_dither", "stats_step", "levels_step", "mod_delay")}}
    step = 2.0 ** -15  # a 16-bit step
    lipshitz = (2.033, -2.165, 1.959, -1.590, 0.6149)
    runs = (
        ("delivery", DELIVERY, "s16", None,
         {"biquad_scan_f32": iir.biquad_scan_f32, "tpdf_dither_f32": td.tpdf_dither_f32,
          "stats_step_f32": td.stats_step_f32},
         # TPDF of +-1 step and the quantizer's error (var step^2 / 4),
         # shaped by 1 - H(z): gain 1 + sum h^2; two draws
         math.sqrt(2 * (1 + sum(h * h for h in lipshitz)) * step ** 2 / 4)),
        ("modulated", MODULATED, "double", -20 * math.log10(2.0 ** 24),
         {"mod_delay_f32": td.mod_delay_f32,
          "tpdf_noise_f32": td.tpdf_noise_f32, "tpdf_dither_f32": td.tpdf_dither_f32,
          "stats_step_f32": td.stats_step_f32, "stats_step_plain_f32": td.stats_step_f32.plain,
          "levels_step_f32": td.levels_step_f32},
         # noise -90's TPDF (var level^2 / 6) and the sloped2 dither's
         # first difference of its error (var 2 step^2 / 4), two draws each
         math.sqrt(2 * (10 ** (-90 / 10) / 6 + 2 * step ** 2 / 4))),
    )
    print(f"float32 slice C chains: dsp-torch on {SECONDS} s with DSP_TPU_TORCH_DTYPE=float32")
    os.environ["DSP_TPU_TORCH_DTYPE"] = "float32"
    try:
        for label, words, enc, limit, f32w, predicted in runs:
            for w in f64w.values():
                w.launches = 0
            err = cli_run(f"{label} float32 -e {enc} -b 2048", words.split(), 2048, f32w,
                          records, src, n_in, head, SECONDS, tmp, enc=enc, limit_dbfs=limit,
                          seed=SLICE_C_SEED, keep=tmp / f"f32_{label}.wav", refs=refs,
                          dtype="float32")
            stray = {name: w.launches for name, w in f64w.items() if w.launches}
            _require(f"{label} float32: float64 kernels ran in the float32 chain: {stray}",
                     not stray)
            table = stats_table(err)
            _require(f"{label} float32: no stats table", table is not None)
            rows32 = _table_rows(table)
            rows64 = _table_rows((tmp / f"f64_{label}.txt").read_text())
            worst = {}
            for row, tol in (("DC offset", F32_TABLE_DC),
                             ("Peak level (dBFS)", F32_TABLE_PEAK_DB[label]),
                             ("RMS level (dBFS)", F32_TABLE_DB)):
                worst[row] = max(abs(a - b) for a, b in zip(rows32[row], rows64[row]))
                _require(f"{label} float32: stats {row} {rows32[row]} against float64 "
                         f"{rows64[row]} (limit {tol})", worst[row] <= tol)
            _require(f"{label} float32: {rows32['Samples']} samples, float64 {rows64['Samples']}",
                     rows32["Samples"] == rows64["Samples"])
            _, y32 = read_wav(tmp / f"f32_{label}.wav")
            _, y64 = read_wav(tmp / f"f64_{label}.wav")
            rms = float(np.sqrt(np.mean((y32 - y64) ** 2)))
            print(f"  {label} float32 against float64 on {SECONDS} s: stats table within "
                  + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                  + f"; RMS of the difference {dbfs(rms):.2f} dBFS; two independent draws of "
                  f"the noise and dither alone predict {dbfs(predicted):.2f} dBFS"
                  + (" (the modulator's draws move the delay too)" if "delay -M" in words else ""))
            (tmp / f"f32_{label}.wav").unlink()
            (tmp / f"f64_{label}.wav").unlink()
        stats_table_check(head, tmp, refs, "float32")
    finally:
        os.environ.pop("DSP_TPU_TORCH_DTYPE")


def float32_no_sync():
    """A float32 chain's step does not synchronise: run_blocks over 16
    blocks of input already on the card, under
    torch.cuda.set_sync_debug_mode("error"), for the flagship at blocks
    2048 (K1-df) and 1000 (K3), resample 48k, matrix4 -6 and matrix4_mb -6
    (with its phase-linearising FIR)."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    rng = np.random.default_rng(14)
    for words, block in F32_RUNS + F32_UPMIXES:
        cc = CompiledChain(build_chain_from_string(words, StreamInfo(FS, CHANNELS)), block,
                           dtype=torch.float32, device="cuda")
        B = cc.block_frames
        xs = torch.as_tensor(rng.standard_normal((20, B, CHANNELS)) * 0.1, dtype=torch.float32,
                             device="cuda")
        cc.run_blocks(xs[:4])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ys = cc.run_blocks(xs[4:])
        except RuntimeError as e:
            raise SmokeError(f"float32 {words} -b {block}: the step synchronised: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if ys.dtype != torch.float32 or not torch.isfinite(ys).all():
            raise SmokeError(f"float32 {words} -b {block}: output {ys.dtype}, finite "
                             f"{bool(torch.isfinite(ys).all())}")
    print("float32 steps: the flagship at blocks 2048 and 1000, resample 48k, matrix4 -6 and "
          "matrix4_mb -6 ran 16 blocks each with no host sync")


def main_path(records, seconds, tmp):
    """The flagship chain, then the FFT-convolution paths, the delivery
    chains and the upmixes, file to file. Their CPU references run ahead
    in REFERENCE_WORKERS worker processes (CpuReferences) while the card
    renders. Returns the 1M- and 4k-tap filter files and the float64
    renders it kept for the float32 phase ({(chain, block): path})."""
    import os

    from dsp_tpu_torch.ops import fft_conv, iir
    from dsp_tpu_torch.ops import m4_engine as m4
    from dsp_tpu_torch.ops import resample_ops
    from dsp_tpu_torch.ops import time_domain as td

    src = tmp / "in.wav"
    t0 = time.perf_counter()
    n_in, head = write_input(src, seconds)
    print(f"main path: wrote {seconds} s of stereo {FS} Hz float64 ({n_in} frames, "
          f"{src.stat().st_size / 1e6:.1f} MB) in {time.perf_counter() - t0:.2f} s")
    f64k, f1m, f4k = tmp / "f64k.wav", tmp / "f1m.wav", tmp / "f4k.wav"
    write_filter(f64k, 1 << 16, seed=0xBE)
    write_filter(f1m, 1 << 20, seed=0xBF)
    write_filter(f4k, 1 << 12, seed=0xC4)
    src60 = tmp / "in60.wav"
    n60, head60 = write_input(src60, 60)
    os.environ["DSP_TPU_TORCH_DEVICE"] = "cuda"
    kept = {}

    def keep(key):  # a float64 render the float32 phase compares with
        kept[key] = tmp / f"f64_{len(kept)}.wav"
        return kept[key]

    # the OLS and Upols steps take their carried input from rfft_pack; the
    # Nupols step splices its stage
    mac = {name: getattr(fft_conv, name) for name in ("rfft_pack", "fdl_mac", "irfft_crop")}
    m4w = {"biquad_scan_series": iir.biquad_scan_series, "m4_env": m4.m4_env,
           "m4_event": m4.m4_event,
           "m4_audio": m4.m4_audio, "splice": fft_conv.splice}
    mbw = {"biquad_scan_run": iir.biquad_scan_run, "lti_blocked": iir.lti_blocked,
           "m4mb_env": m4.m4mb_env, "m4mb_event": m4.m4mb_event, "m4mb_audio": m4.m4mb_audio,
           "splice": fft_conv.splice, "rfft_pack": fft_conv.rfft_pack,
           "fdl_mac": fft_conv.fdl_mac, "irfft_crop": fft_conv.irfft_crop}
    mb = {"onset": MB_ONSET, "compare": MB_COMPARE_SECONDS}
    k12 = {"lti_blocked": iir.lti_blocked, "crossfeed_step": iir.crossfeed_step}
    on60 = (src60, n60, head60, 60)
    # (label, chain words, block, wrappers, cli_run's keywords, the input
    # (src, frames, head, seconds) or None for in.wav), in the card's order
    runs = [
        (f"flagship -b {block}", FLAGSHIP.split(), block, k12,
         {"keep": keep((FLAGSHIP, block))} if block == 2048 else {}, None)
        for block in (2048, 65536)
    ] + [
        # at a block K1 does not take, the six biquads run per sample, as
        # one run on K2 (a launch for the six)
        ("flagship -b 1000", FLAGSHIP.split(), 1000,
         {"biquad_scan_run": iir.biquad_scan_run, "crossfeed_step": iir.crossfeed_step},
         {"keep": keep((FLAGSHIP, 1000))}, None),
        # a lone per-sample biquad: K2 on its (hi, lo) state
        (f"{LONE_BIQUAD} -b 1000", LONE_BIQUAD.split(), 1000,
         {"biquad_scan_pair": iir.biquad_scan_pair}, {"keep": keep((LONE_BIQUAD, 1000))}, None),
        ("fir 64k -b 65536 (OLS)", ["fir", str(f64k)], 65536, mac,
         {"keep": keep(("fir 64k", 65536))}, None),
        ("fir 64k -b 2048 (Upols, K = 32)", ["fir", str(f64k)], 2048, mac,
         {"keep": keep(("fir 64k", 2048))}, None),
        ("fir_p 1M -b 2048 (Nupols, m = 32)", ["fir_p", str(f1m)], 2048,
         {**mac, "splice": fft_conv.splice}, {"keep": keep(("fir_p 1M", 2048))}, None),
        ("fir_p 1M -b 65536 (Upols, K = 16)", ["fir_p", str(f1m)], 65536, mac, {}, None),
        ("crossover_lr4_2kHz_riir_linphase -b 2048", [f"@{CROSSOVER}"], 2048,
         {"lti_blocked": iir.lti_blocked, **mac}, {}, None),
        # slice C: numpy's generator seeded alike before the card and CPU
        # runs (their renders and stats tables kept as tmp/f64_<label>.wav
        # and .txt for float32_time_domain_cli)
        ("delivery -e s16 -b 2048", DELIVERY.split(), 2048,
         {"biquad_scan": iir.biquad_scan, "tpdf_dither": td.tpdf_dither,
          "stats_step": td.stats_step},
         {"enc": "s16", "limit_dbfs": None, "seed": SLICE_C_SEED,
          "keep": tmp / "f64_delivery.wav"}, None),
        ("modulated -b 2048", MODULATED.split(), 2048,
         {"mod_delay": td.mod_delay,
          "tpdf_noise": td.tpdf_noise, "tpdf_dither": td.tpdf_dither,
          "stats_step": td.stats_step, "stats_step_plain": td.stats_step.plain,
          "levels_step": td.levels_step},
         {"limit_dbfs": -280.0, "seed": SLICE_C_SEED, "keep": tmp / "f64_modulated.wav"}, None),
        # slices D and E: the upmixes
        ("matrix4 -6 -b 2048 (44.1 kHz -> 4 ch)", MATRIX4.split(), 2048, m4w,
         {"keep": keep((MATRIX4, 2048))}, None),
        # a block of 2048 control ticks, where the engine sets the pace
        ("matrix4 -6 -b 65536 (44.1 kHz -> 4 ch)", MATRIX4.split(), 65536, m4w, {}, None),
        # on 60 s, as the mixed chain below (the split phase's time)
        ("resample 48k matrix4 -6 -b 2048 (48 kHz quad)", UPMIX48.split(), 2048,
         {**m4w, "resample_step": resample_ops.resample_step}, {"onset": ONSET}, on60),
        # the resampler's route of three launches: an inverse at N = 88,202
        # with a global pass of the prime 44,101 (blocks of 44,100 frames)
        ("resample 44101 (the route of three launches)", ["resample", "44101"], 2048,
         {"rfft_pack": fft_conv.rfft_pack, "resample_fold": resample_ops.resample_fold,
          "irfft_ola": resample_ops.irfft_ola}, {}, on60),
        # slice F: the multiband upmixes (the fir before the effect is its
        # phase-linearising FIR, on K5/K6)
        ("matrix4_mb -6 -b 2048 (44.1 kHz -> 4 ch)", MATRIX4_MB.split(), 2048, mbw,
         {**mb, "keep": keep((MATRIX4_MB, 2048))}, None),
        ("matrix4_mb -6 -b 65536 (44.1 kHz -> 4 ch)", MATRIX4_MB.split(), 65536, mbw, mb, None),
        ("mixed -b 2048 (eq, delay -f, fir 4k, matrix4_mb)", mixed_chain(f4k).split(), 2048,
         mbw, mb, on60),
        ("examples/matrix4_mb_2_4 -b 2048 (6 ch)", [f"@{MB_EXAMPLE}"], 2048, mbw, mb, on60),
    ] + [
        # -b 1000: the chain rounds the block up to 1024 (its quantum of 32
        # samples), an L = 128 plan; -b 1056 is off the 128 grid: the
        # bank's L = 1 plan, which K1 runs in chunks of 32
        # (csrc/lti_blocked.cu)
        (f"matrix4_mb -6 -b {block} (44.1 kHz -> 4 ch, the bank at {bank})", MATRIX4_MB.split(),
         block, mbw, mb, on60)
        for block, bank in ((1000, "L = 128 at 1024"), (1056, "L = 1"))
    ]
    # the runs whose bank launches count as lti_blocked@bank's
    bank_runs = {"matrix4_mb -6 -b 2048 (44.1 kHz -> 4 ch)",
                 "matrix4_mb -6 -b 1000 (44.1 kHz -> 4 ch, the bank at L = 128 at 1024)",
                 "matrix4_mb -6 -b 1056 (44.1 kHz -> 4 ch, the bank at L = 1)"}
    refs = CpuReferences(REFERENCE_WORKERS)
    try:
        for _, words, block, _, kw, inp in runs:
            refs.submit(words, block, head if inp is None else inp[2],
                        **{k: kw[k] for k in ("enc", "seed", "compare") if k in kw})
        refs.submit_tables(head, tmp)
        for label, words, block, wrappers, kw, inp in runs:
            src_i, n_i, head_i, secs = (src, n_in, head, seconds) if inp is None else inp
            err = cli_run(label, words, block, wrappers, records, src_i, n_i, head_i, secs, tmp,
                          refs=refs, **kw)
            if label in bank_runs:
                records["lti_blocked@bank"]["launches"] += iir.lti_blocked.launches
            if label.startswith(("delivery", "modulated")):
                table = stats_table(err)
                if table is None:
                    raise SmokeError(f"the {label.split()[0]} run printed no stats table")
                if label.startswith("delivery"):
                    print("  " + table.replace("\n", "\n  "))
                (tmp / f"f64_{label.split()[0]}.txt").write_text(table)
                if label.startswith("modulated"):
                    stats_table_check(head, tmp, refs)
        left = refs.close()
    finally:
        refs.close()
    if left:
        raise SmokeError(f"main path: {left} CPU references were computed for no run")
    return f1m, f4k, kept


# --- slice H1: split and batched processing over a stream axis ---------------

# the stream-axis forms are held at FORM_STREAMS streams and timed at one
# stream ([B, C], the sequential call) and at TIMED_STREAMS
FORM_STREAMS = 3
TIMED_STREAMS = 8
# the split renders (DSP_TPU_SPLIT): segments, and the limit on split
# against sequential in float64 (tests/test_split.py's contract)
SPLIT_SEGMENTS = 8
SPLIT_DBFS = -150.0
# process_batch: streams, seconds a stream, and the limit on a stream
# against process_array (tests/test_state_hygiene.py)
BATCH_STREAMS = 8
BATCH_SECONDS = 5
BATCH_ABS = 1e-12
RESAMPLE_ABS = 10.0 ** (RESAMPLE_DBFS / 20.0)
# (record, the wrapper whose own count is the form's launches), for every
# stream-axis form; a form's row counts its launches in the split phase's
# split renders and batches, where every launch runs S streams
STREAM_FORMS = (
    ("lti_blocked@S", "iir.lti_blocked"), ("lti_blocked_f32@S", "iir.lti_blocked_f32"),
    ("crossfeed_step@S", "iir.crossfeed_step"), ("crossfeed_step_f32@S", "iir.crossfeed_step_f32"),
    ("biquad_scan_run@S", "iir.biquad_scan_run"), ("biquad_scan_run_df@S", "iir.biquad_scan_run_df"),
    ("biquad_scan@S", "iir.biquad_scan"), ("biquad_scan_f32@S", "iir.biquad_scan_f32"),
    ("biquad_scan_pair@S", "iir.biquad_scan_pair"), ("biquad_scan_df@S", "iir.biquad_scan_df"),
    ("rfft_pack@S", "fc.rfft_pack"), ("rfft_pack_f32@S", "fc.rfft_pack_f32"),
    ("fdl_mac@S", "fc.fdl_mac"), ("fdl_mac_f32@S", "fc.fdl_mac_f32"),
    ("irfft_crop@S", "fc.irfft_crop"), ("irfft_crop_f32@S", "fc.irfft_crop_f32"),
    ("splice@S", "fc.splice"), ("splice_f32@S", "fc.splice_f32"),
    ("resample_step@S", "ro.resample_step"), ("resample_step_f32@S", "ro.resample_step_f32"),
    ("irfft_ola@S", "ro.irfft_ola"), ("irfft_ola_f32@S", "ro.irfft_ola_f32"),
)


def _stream_wrappers():
    """{record: wrapper} of STREAM_FORMS."""
    from dsp_tpu_torch.ops import fft_conv as fc
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import resample_ops as ro

    mods = {"iir": iir, "fc": fc, "ro": ro}
    return {rec: getattr(mods[w.split(".")[0]], w.split(".")[1]) for rec, w in STREAM_FORMS}


def _pick(tree, s):
    """Stream s of a tree of stream-axis tensors (a 0-dim leaf is every
    stream's)."""
    import torch

    if isinstance(tree, (tuple, list)):
        return type(tree)(_pick(t, s) for t in tree)
    if isinstance(tree, dict):
        return {k: _pick(v, s) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor) or tree.dim() == 0:
        return tree
    return tree[s]


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def kernel_total():
    """Every kernel the port has launched in this process: the libraries'
    own counts, and the wrappers' where a kernel has no library count."""
    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.ops import fft_conv as fc
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import resample_ops as ro

    return (kernels.lookback_launches() + kernels.fft_launches() + kernels.biquad_run_launches()
            + kernels.resample_launches() + kernels.noise_launches() + kernels.dither_launches()
            + kernels.upmix_launches()
            + kernels.mod_delay_launches() + sum(kernels.meter_launches())
            + sum(w.launches for w in (iir.crossfeed_step, iir.crossfeed_step_f32, iir.biquad_scan,
                                       iir.biquad_scan_f32, iir.biquad_scan_pair,
                                       iir.biquad_scan_df, fc.fdl_mac, fc.fdl_mac_f32, fc.splice,
                                       fc.splice_f32, ro.resample_fold)))


def split_kernel_phase(records, groups=("split", "upmix", "td")):
    """Every kernel form with a stream axis (groups: the split-safe
    effects' path, the upmixes', upmix_forms, and the time-domain effects',
    td_forms), on the card: at S = FORM_STREAMS one launch a call by its own count (the
    route of three launches: the launches of one stream's call), each
    stream bit-equal to a one-stream call of the kernel, and the whole
    within its plain version on the same inputs on the card at the
    tolerances of the one-stream rows (K1: K1_ABS; float64: LIMIT_DBFS, the
    resampler's step RESAMPLE_DBFS; float32: one float32 ulp of the scale,
    a (hi, lo) state's sum within F32_STATE_REL). Each form timed, a call
    (CUDA events) and device-only (torch.profiler), at one stream ([B, C])
    and at TIMED_STREAMS, its plain version (at the form's plain_streams)
    and, where one PyTorch call computes the same function, that call, at
    TIMED_STREAMS."""
    import numpy as np
    import torch

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops import fft_conv as fc
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import resample_ops as ro

    dev = torch.device("cuda")
    rng = np.random.default_rng(20318)
    f64, f32 = torch.float64, torch.float32
    C = CHANNELS
    plan, _ = flagship_parts()
    effects = build_chain_from_string(FLAGSHIP, StreamInfo(FS, C)).effects
    cf = next(e for e in effects if e.name == "crossfeed")
    hp = next(e for e in effects if e.name == "highpass")
    gains = (cf.direct_gain, cf.cross_gain)
    run6 = tuple(torch.as_tensor(a, device=dev) for a in run_biquads(6, C))
    hp64 = tuple(torch.as_tensor(getattr(hp, k), device=dev) for k in ("_ss_A", "_ss_Bv", "_ss_c0"))
    hp32 = tuple(t.float() for t in hp64)
    cf_args = {dt: tuple(torch.as_tensor(getattr(cf, f"_ss{'32' if dt == f32 else ''}_{k}"),
                                         device=dev) for k in ("A", "Bv", "c0"))
               for dt in (f64, f32)}
    rs48, rs44101 = ro.SpectralResampler(FS, 48000), ro.SpectralResampler(FS, 44101)
    H32 = torch.as_tensor(rng.standard_normal((32, 2049, C)) + 1j * rng.standard_normal((32, 2049, C)),
                          device=dev) * 1e-2

    def normal(S, *shape, dtype=f64, scale=0.3):
        lead = (S,) if S else ()
        return torch.as_tensor(rng.standard_normal(lead + shape) * scale, dtype=dtype, device=dev)

    log2 = math.log2
    forms = []
    group = ["split"]

    def form(rec, what, call, plain, make, streamed, count, cost, pairs=(), limit=None,
             library=None, reps=50, one=True, hold=None, lane=False, plain_streams=TIMED_STREAMS):
        """A form: call(*args) and plain(*args) on make(S)'s args (S = 0:
        one stream, no stream axis); `streamed` maps the position of each
        argument with a stream axis to how stream s is cut from it (None:
        its index s); count() the form's launches; cost(S) its (bytes,
        operations, peak); pairs the output leaves that are float32 (hi,
        lo) states; limit an absolute bound on the float64 outputs; rec
        None: checked, not timed; hold(got, ref) the one-stream rows' own
        check against the plain version (raises; returns the error kept),
        in place of the generic one; lane: a stream is a lane of the
        kernel, its one-stream call a lane of one (the event engine);
        plain_streams the streams at which the plain version is timed:
        FORM_STREAMS, the one call of the check (a plain version that takes
        seconds a call), or TIMED_STREAMS, up to 5 calls."""
        if group[0] in groups:
            forms.append((rec, what, call, plain, make, streamed, count, cost, pairs, limit,
                          library, reps, one, hold, lane, plain_streams))

    # K1 and K1-df on the flagship's cascade (n = 12), B = 2048
    n = plan.n
    for dt, rec in ((f64, "lti_blocked@S"), (f32, "lti_blocked_f32@S")):
        w = 8 if dt == f64 else 4
        form(rec, f"{rec} (flagship cascade, B=2048)",
             lambda st, x: iir.lti_blocked(plan, st, x),
             lambda st, x: iir.lti_blocked_ref(plan, st, x) if x.dtype == f64
             else iir.lti_blocked_f32_ref(plan, st, x),
             lambda S, dt=dt: (normal(S, 2, C, n, dtype=dt, scale=1e-2), normal(S, 2048, C, dtype=dt)),
             (0, 1), kernels.lookback_launches,
             lambda S, w=w: (S * w * (2 * 2048 * C + 4 * C * n) + 8 * (C * 128 + 2 * C * n * 128
                                                                     + C * n * n + C),
                             S * (2 * C * 16 * (128 * 127 // 2 + 2 * n * 128 + n * n)
                                  + 2 * 2048 * C), F64_PEAK),
             pairs=(0,) if dt == f32 else (), limit=K1_ABS if dt == f64 else None)
    # crossfeed's step, B = 2048
    for dt, rec in ((f64, "crossfeed_step@S"), (f32, "crossfeed_step_f32@S")):
        w = 8 if dt == f64 else 4
        form(rec, f"{rec} (B=2048)",
             lambda st, x, dt=dt: iir.crossfeed_step(*cf_args[dt], st, x, 0, 1, *gains),
             lambda st, x, dt=dt: iir.crossfeed_step_ref(*cf_args[dt], st, x, 0, 1, *gains),
             lambda S, dt=dt: (normal(S, 4, 2, dtype=dt, scale=1e-2), normal(S, 2048, C, dtype=dt)),
             (0, 1), lambda dt=dt: (iir.crossfeed_step if dt == f64 else iir.crossfeed_step_f32).launches,
             lambda S, w=w: (w * (S * (2 * 2048 * C + 16) + 28), 50 * 2048 * S,
                             F64_PEAK if w == 8 else F32_PEAK))
    # the run of the flagship's six biquads, B = 1000, (hi, lo) states
    for dt, rec in ((f64, "biquad_scan_run@S"), (f32, "biquad_scan_run_df@S")):
        w = 8 if dt == f64 else 4
        form(rec, f"{rec} (six biquads, B=1000, (hi, lo) states)",
             lambda sts, x: iir.biquad_scan_run(*run6, sts, x),
             lambda sts, x: iir.biquad_scan_run_ref(*run6, sts, x),
             lambda S, dt=dt: ([normal(S, 2, C, 2, dtype=dt, scale=1e-2) for _ in range(6)],
                               normal(S, 1000, C, dtype=dt)),
             (0, 1), kernels.biquad_run_launches,
             lambda S, w=w: (w * S * (2 * 1000 * C + 6 * 8 * C) + 8 * 6 * 7 * C,
                             10 * 1000 * C * 6 * S, F64_PEAK), pairs=(0, 1, 2, 3, 4, 5))
    # the lone K2 (the Thiran delay's sections) and K3 / K2 on the (hi, lo)
    # state (a lone per-sample biquad), the 30 Hz highpass
    for rec, fn, coef, dt, pair, B in (
            ("biquad_scan@S", iir.biquad_scan, hp64, f64, False, 2048),
            ("biquad_scan_f32@S", iir.biquad_scan_f32, hp32, f32, False, 2048),
            ("biquad_scan_pair@S", iir.biquad_scan_pair, hp64, f64, True, 1000),
            ("biquad_scan_df@S", iir.biquad_scan_df, hp64, f32, True, 1000)):
        w = 8 if dt == f64 else 4
        ref = {"biquad_scan@S": iir.biquad_scan_ref, "biquad_scan_f32@S": iir.biquad_scan_f32_ref,
               "biquad_scan_pair@S": iir.biquad_scan_pair_ref,
               "biquad_scan_df@S": iir.biquad_scan_df_ref}[rec]
        form(rec, f"{rec} (highpass 30, B={B})",
             lambda st, x, fn=fn, coef=coef: fn(*coef, st, x),
             lambda st, x, ref=ref, coef=coef: ref(*coef, st, x),
             lambda S, dt=dt, pair=pair, B=B: (
                 normal(S, *((2,) if pair else ()), C, 2, dtype=dt, scale=1e-2),
                 normal(S, B, C, dtype=dt)),
             (0, 1), lambda fn=fn: fn.launches,
             lambda S, w=w, B=B, pair=pair: (w * S * (2 * B * C + (8 if pair else 4) * C)
                                             + 8 * 7 * C, 10 * B * C * S, F64_PEAK),
             pairs=(0,) if pair and dt == f32 else ())
    # the FFT convolution's wrappers: N = 4096 (the Upols step at B = 2048),
    # the FDL of K = 32, the Nupols stage of P = 65536
    N = 4096
    for dt, sfx in ((f64, ""), (f32, "_f32")):
        w = 8 if dt == f64 else 4
        form(f"rfft_pack{sfx}@S", f"rfft_pack{sfx}@S (N={N}, keep 2048)",
             lambda a, x: fc.rfft_pack(a, x, N, keep=2048),
             lambda a, x: (fc.rfft_pack_ref(a, x, N, keep=2048) if x.dtype == f64
                           else fc.rfft_pack_f32_ref(x, N, a, keep=2048)),
             lambda S, dt=dt: (normal(S, 2048, C, dtype=dt), normal(S, 2048, C, dtype=dt)),
             (0, 1), kernels.fft_launches,
             lambda S, w=w: (S * (w * 3 * 2048 * C + 16 * (N // 2 + 1) * C),
                             S * C * 2.5 * N * log2(N), F64_PEAK),
             library=lambda a, x: torch.fft.rfft(torch.cat([a, x], dim=-2), n=N, dim=-2))
        form(f"fdl_mac{sfx}@S", f"fdl_mac{sfx}@S (K=32, NB=2049)",
             lambda X, fdl, dt=dt: fc.fdl_mac(X, H32, fdl, dtype=dt),
             lambda X, fdl, dt=dt: (fc.fdl_mac_ref(X, H32, fdl) if dt == f64
                                    else fc.fdl_mac_f32_ref(X, H32, fdl)),
             lambda S, dt=dt: (normal(S, 2049, C, dtype=f64).to(torch.complex128),
                               normal(S, 32, 2049, C, 2, dtype=dt, scale=1e-2)),
             (0, 1), lambda sfx=sfx: getattr(fc, f"fdl_mac{sfx}").launches,
             lambda S, w=w: (S * 2049 * C * (32 + 2 * w * 2 * 31) + 16 * 32 * 2049 * C,
                             8 * 32 * 2049 * C * S, F64_PEAK))
        form(f"irfft_crop{sfx}@S", f"irfft_crop{sfx}@S (N={N}, rows [2048, 4096), the addend)",
             lambda Y, add, dt=dt: fc.irfft_crop(Y, N, 2048, 2048, add, dtype=dt),
             lambda Y, add, dt=dt: (fc.irfft_crop_ref(Y, N, 2048, 2048, add) if dt == f64
                                    else fc.irfft_crop_f32_ref(Y, N, 2048, 2048, add)),
             lambda S, dt=dt: (normal(S, N // 2 + 1, C).to(torch.complex128),
                               normal(S, 2048, C, dtype=dt)),
             (0, 1), kernels.fft_launches,
             lambda S, w=w: (S * (16 * (N // 2 + 1) * C + 2 * w * 2048 * C),
                             S * C * 2.5 * N * log2(N), F64_PEAK),
             library=lambda Y, add: torch.fft.irfft(Y, n=N, dim=-2)[..., 2048:, :] + add)
        form(f"splice{sfx}@S", f"splice{sfx}@S (the Nupols stage, L=65536)",
             lambda a, x: fc.splice(a, x, 65536, 5 * 2048, 0),
             lambda a, x: fc.splice_ref(a, x, 65536, 5 * 2048, 0),
             lambda S, dt=dt: (normal(S, 65536, C, dtype=dt), normal(S, 2048, C, dtype=dt)),
             (0, 1), lambda sfx=sfx: getattr(fc, f"splice{sfx}").launches,
             lambda S, w=w: (2 * w * S * 65536 * C, 0, F64_PEAK),
             library=lambda a, x: torch.cat([a[..., :5 * 2048, :], x, a[..., 6 * 2048:, :]], dim=-2))
    # the resampler's step: one launch at 44.1 -> 48 kHz (4 inner blocks of
    # 588 frames); the route of three launches at 44.1 -> 44.101 kHz (one
    # inner block of 44,100 frames), checked whole, its inverse with the
    # overlap-add (irfft_ola, the one of its three wrappers that reads the
    # streams apart) timed alone
    for rs, label, n_in, lim, reps in ((rs48, "48 kHz, 4 x 588 frames", 4, RESAMPLE_ABS, 50),
                                       (rs44101, "44.101 kHz, the route of three launches", 1,
                                        10.0 ** (LIMIT_DBFS / 20.0), 3)):
        Nf, Ni, T = 2 * rs.in_len, 2 * rs.out_len, len(rs.tab_l)
        for dt, rec in ((f64, "resample_step@S"), (f32, "resample_step_f32@S")):
            one_launch = rs is rs48
            if not one_launch:
                rec = None
            w = 8 if dt == f64 else 4
            form(rec, f"{'resample_step' if dt == f64 else 'resample_step_f32'}@S ({label})",
                 lambda ov, x, rs=rs: ro.resample_step(rs, ov, x),
                 lambda ov, x, rs=rs: (ro.resample_step_ref(rs, ov, x) if x.dtype == f64
                                       else ro.resample_step_f32_ref(rs, ov, x)),
                 lambda S, dt=dt, rs=rs, n_in=n_in: (normal(S, rs.out_len, C, dtype=dt, scale=1e-2),
                                                     normal(S, n_in * rs.in_len, C, dtype=dt)),
                 (0, 1), (kernels.resample_launches if one_launch else
                          lambda: kernels.fft_launches() + ro.resample_fold.launches),
                 lambda S, w=w, n_in=n_in, rs=rs, Nf=Nf, Ni=Ni, T=T: (
                     w * S * C * (n_in * rs.in_len + rs.out_len * (n_in + 2))
                     + 4 * (rs.out_len + 2) + 24 * T + 20 * (Nf + Ni),
                     S * n_in * C * (2.5 * (Nf * log2(Nf) + Ni * log2(Ni)) + 8 * T
                                     + 3 * rs.out_len), F64_PEAK),
                 limit=lim if dt == f64 else None, reps=reps, one=one_launch)
    Ni, half = 2 * rs44101.out_len, rs44101.out_len
    ratio = rs44101.out_len / rs44101.in_len
    for dt, rec in ((f64, "irfft_ola@S"), (f32, "irfft_ola_f32@S")):
        w = 8 if dt == f64 else 4
        ola = ro.irfft_ola if dt == f64 else ro.irfft_ola_f32
        ola_ref = ro.irfft_ola_ref if dt == f64 else ro.irfft_ola_f32_ref
        form(rec, f"{rec} (N={Ni}: resample 44101's inverse and overlap-add, an inner block a "
                  f"stream)",
             lambda Y, ov, ola=ola: ola(Y, Ni, ov, ratio),
             lambda Y, ov, ola_ref=ola_ref: ola_ref(Y, Ni, ov, ratio),
             lambda S, dt=dt: (torch.complex(normal(S, half + 1, C), normal(S, half + 1, C))
                               .transpose(0, 1).reshape(half + 1, -1) if S else
                               torch.complex(normal(0, half + 1, C), normal(0, half + 1, C)),
                               normal(S, half, C, dtype=dt, scale=1e-2)),
             {0: lambda Y, s: Y[:, s * C:(s + 1) * C].contiguous(), 1: None},
             kernels.fft_launches,
             lambda S, w=w: (16 * (half + 1) * C * S + w * half * 3 * C * S + 20 * Ni,
                             (2.5 * Ni * log2(Ni) + 3 * half) * C * S, F64_PEAK),
             library=lambda Y, ov: torch.fft.irfft(Y, n=Ni, dim=0), reps=3, one=False,
             limit=10.0 ** (LIMIT_DBFS / 20.0) if dt == f64 else None)
    if "upmix" in groups:
        group[0] = "upmix"
        upmix_forms(form)
    group[0] = "td"
    if "td" in groups:
        td_forms(form)

    for (rec, what, call, plain, make, streamed, count, cost, pairs, limit, library, reps,
         one, hold, lane, plain_streams) in forms:
        print(f"{what}: S={FORM_STREAMS} in one call")
        args = make(FORM_STREAMS)
        cut = streamed if isinstance(streamed, dict) else {k: None for k in streamed}

        def stream(s, args=args, cut=cut):
            out = []
            for k, a in enumerate(args):
                if k not in cut:
                    out.append(a)
                elif cut[k] is not None:
                    out.append(cut[k](a, s))
                else:
                    out.append([t[s] for t in a] if isinstance(a, list) else a[s])
            return tuple(out)

        torch.cuda.synchronize()
        c0 = count()
        call(*stream(0))
        torch.cuda.synchronize()
        c1 = count()
        got = call(*args)
        torch.cuda.synchronize()
        want, n_s = c1 - c0, count() - c1
        _require(f"{what}: {n_s} launches at S={FORM_STREAMS}, {want} at one stream"
                 + (", expected 1" if one else ""), n_s == want and (want == 1 or not one))
        for s in range(FORM_STREAMS):
            mine = call(*stream(s))
            mine = _leaves(_pick(mine, 0) if lane else mine)
            _require(f"{what}: stream {s} differs from a one-stream call of the kernel",
                     all(bits_equal(a, b) for a, b in zip(_leaves(_pick(got, s)), mine)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plain(*args)
        torch.cuda.synchronize()
        check_ms = (time.perf_counter() - t0) * 1e3
        err = 0.0
        for k, (g, r) in enumerate(zip(_leaves(got), _leaves(ref)) if hold is None else ()):
            if g.dtype == torch.complex128:
                g, r = torch.view_as_real(g), torch.view_as_real(r)
            if g.dtype == f32:
                if k in pairs:
                    rel = _pair_rel(g.transpose(0, 1), r.transpose(0, 1))
                    _require(f"{what}: (hi, lo) state {rel:.2e} relative from the plain version",
                             rel <= F32_STATE_REL)
                else:
                    ulps, e = _ulps(g, r)
                    _require(f"{what}: {ulps:.2f} float32 ulp of the scale from the plain version",
                             ulps <= 1.0)
                    err = max(err, e)
                continue
            e = _diff(g, r)
            err = max(err, e)
        if hold is not None:
            err = hold(got, ref)
            print(f"  {what}: each stream bit-equal to a one-stream call; within the plain "
                  f"version at the one-stream rows' tolerances ({err:.3e})")
        elif any(g.dtype != f32 for g in _leaves(got)):
            check_close(f"{what}: each stream bit-equal to a one-stream call; plain version", err)
        else:
            print(f"  {what}: each stream bit-equal to a one-stream call; float32 within one "
                  f"ulp of the plain version's scale")
        if limit is not None:
            _require(f"{what}: {err:.3e} from the plain version, above {limit:.1e}", err <= limit)
        if rec is None:
            continue
        row = records[rec]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        # times: one stream ([B, C]) and TIMED_STREAMS
        times = {}
        for S in (0, TIMED_STREAMS):
            a_S = make(S)
            ms = cuda_ms(lambda: call(*a_S), reps)
            dev_ms, kern = device_ms(lambda: call(*a_S), min(reps, 20))
            times[S] = (ms, dev_ms, kern)
        a8 = make(TIMED_STREAMS)
        plain_ms = (check_ms if plain_streams == FORM_STREAMS
                    else cuda_ms(lambda: plain(*a8), min(reps, 5)))
        lib_ms = None if library is None else cuda_ms(lambda: library(*a8), reps)
        nbytes, flops, peak = cost(TIMED_STREAMS)
        set_times(row, times[TIMED_STREAMS][0], plain_ms, nbytes, flops, lib_ms, peak)
        if plain_streams != TIMED_STREAMS:
            row["plain_streams"] = plain_streams
        row["device_ms"] = times[TIMED_STREAMS][1]
        row["ms_s1"], row["device_ms_s1"] = times[0][0], times[0][1]
        print(f"  S=1: {times[0][0]:.4f} ms a call, {times[0][1]:.4f} ms device-only "
              f"({times[0][2]} kernels); S={TIMED_STREAMS}: {times[TIMED_STREAMS][0]:.4f} ms a "
              f"call, {times[TIMED_STREAMS][1]:.4f} ms device-only ({times[TIMED_STREAMS][2]} "
              f"kernels); plain {plain_ms:.4f} ms at S={plain_streams}"
              + ("" if lib_ms is None else f"; library {lib_ms:.4f} ms")
              + f"; bound {row['bound_ms']:.6f} ms ({row['bound_by']})")


# slice H2a: the upmixes' kernels with a stream axis, the stream-axis rows
# of split_kernel_phase (record, wrapper), counted in batch_upmix_phase
UPMIX_FORMS = (
    ("biquad_scan_series@S", "iir.biquad_scan_series"),
    ("m4_env@S", "m4.m4_env"), ("m4_env_f32@S", "m4.m4_env_f32"),
    ("m4mb_env@S", "m4.m4mb_env"), ("m4mb_env_f32@S", "m4.m4mb_env_f32"),
    ("m4_event@S", "m4.m4_event"), ("m4_event_f32@S", "m4.m4_event_f32"),
    ("m4mb_event@S", "m4.m4mb_event"), ("m4mb_event_f32@S", "m4.m4mb_event_f32"),
    ("m4_audio@S", "m4.m4_audio"), ("m4_audio_f32@S", "m4.m4_audio_f32"),
    ("m4mb_audio@S", "m4.m4mb_audio"), ("m4mb_audio_f32@S", "m4.m4mb_audio_f32"),
)
# process_batch of the upmixes: seconds a stream (the streams are
# BATCH_STREAMS), the blocks and the probe at the rate whose rings sit in
# the device scratch
UPMIX_BATCH_SECONDS = 20
UPMIX_BATCH_BLOCKS = (2048, 65536)
RING_PROBE = ("matrix4_mb -6", 470400, 2, 0.5)  # (chain, rate, streams, seconds)


def _upmix_wrappers():
    """{record: wrapper} of UPMIX_FORMS."""
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    mods = {"iir": iir, "m4": m4}
    return {rec: getattr(mods[w.split(".")[0]], w.split(".")[1]) for rec, w in UPMIX_FORMS}


def upmix_streams(words, dtype, S, B=2048, warm=2.0, seed=60):
    """An upmix's effect, its stream-axis state after `warm` s of S streams
    of transients (each its own seed) through its chain on the card, and
    the next block x [S, B, 2]."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    cc = CompiledChain(build_chain_from_string(words, StreamInfo(FS, CHANNELS)), B, dtype=dtype,
                       device="cuda")
    nb = int(warm * FS) // B
    n = (nb + 1) * B
    xs = torch.as_tensor(np.stack([transient_signal(n / FS + 0.01, seed=seed + s)[:n]
                                   for s in range(S)]), dtype=dtype, device="cuda")
    states = cc._stream_states(cc.states, S)
    for b in range(nb):
        states, _ = cc._step(states, xs[:, b * B:(b + 1) * B].contiguous())
    i = next(i for i, e in enumerate(cc._runtime_effects) if hasattr(e, "ctl"))  # the upmix
    ev = states[i]["ev"]
    _require(f"{words}: no event in the streams' warm-up",
             int(ev["diff_count"].sum()) + int(ev["ord_count"].sum()) > 0)
    return cc._runtime_effects[i], states[i], xs[:, nb * B:].contiguous()


def upmix_forms(form):
    """The upmixes' stream-axis forms for split_kernel_phase: matrix4's
    band-limit pair (biquad_scan_series), K11 (m4_env; m4mb_env, also with
    the frequency mask's weights), K9 + K10 (m4_event, whose lanes are the
    streams; m4mb_event, a block a stream) and K12 + K13 (m4_audio,
    m4mb_audio), and their float32 forms, at B = 2048 on the states of
    TIMED_STREAMS streams after 2 s of transients (each stream's engine in
    its own state), the inputs each kernel's stage of the step gives it.
    Each held against its plain version at the one-stream rows'
    tolerances (matrix4_phase, matrix4_mb_phase, float32_m4_phase)."""
    import torch

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.ops import iir
    from dsp_tpu_torch.ops import m4_engine as m4

    f64, f32, B, C, S8 = torch.float64, torch.float32, 2048, CHANNELS, TIMED_STREAMS
    Nc = B // 32

    def cut(a, S, lane=False):
        """The first S streams of a (a tensor or a dict of them); S = 0: the
        first stream alone, without the axis (lane: a lane of one)."""
        if isinstance(a, dict):
            return {k: cut(v, S, lane) for k, v in a.items()}
        return a[:S] if S else (a[:1] if lane else a[0])

    def pick(lane):
        def fn(a, s):
            if isinstance(a, dict):
                return {k: fn(v, s) for k, v in a.items()}
            return a[s:s + 1] if lane else a[s]
        return fn

    def maker(*args, lane=False):
        return lambda S: tuple(cut(a, S, lane) for a in args)

    def streamed(n, lane=False):
        return {i: pick(lane) for i in range(n)}

    def rel_env(limit):
        def hold(got, ref):
            rel = abs_ = 0.0
            n = len(got)  # (env, ds) or (env, env_lo, ds)
            pairs = [(got[-1], ref[-1])]
            pairs.append((got[0], ref[0]) if n == 2 else
                         (got[0].double() + got[1].double(), ref[0].double() + ref[1].double()))
            for g, r in pairs:
                rel, abs_ = max(rel, _rel(g, r)), max(abs_, _diff(g, r))
            _require(f"envelopes {rel:.3e} relative from the plain version", rel <= limit)
            _require(f"envelopes {abs_:.3e} absolute from the plain version", abs_ <= ENV_ABS)
            return abs_
        return hold

    def hold_event(limit):
        def hold(got, ref):
            rel = 0.0
            for k, kind in m4.EV_LEAVES:
                if kind != "f":
                    _require(f"the event state's {k} differs from the plain version",
                             torch_equal(got[0][k], ref[0][k]))
                else:
                    rel = max(rel, _rel(got[0][k], ref[0][k]))
            for g, r in zip(got[1:], ref[1:]):
                rel = max(rel, _rel(g, r))
            _require(f"the engine's floats {rel:.3e} relative from the plain version",
                     rel <= limit)
            return rel
        return hold

    def hold_engine_f32(limit):
        def hold(got, ref):
            return _hold_engine("the float32 engine", got, ref, limit)[0]
        return hold

    def hold_abs(limit_dbfs):
        def hold(got, ref):
            err = max(_diff(g, r) for g, r in zip(_leaves(got), _leaves(ref)))
            _require(f"{dbfs(err):.1f} dBFS from the plain version", dbfs(err) <= limit_dbfs)
            return err
        return hold

    def hold_ulp(got, ref):
        worst = err = 0.0
        for g, r in zip(_leaves(got), _leaves(ref)):
            u, e = _ulps(g, r)
            worst, err = max(worst, u), max(err, e)
        _require(f"{worst:.2f} float32 ulp of the scale from the plain version", worst <= 1.0)
        return err

    # each upmix and dtype in a function of its own, so that the forms'
    # closures keep that section's effect and inputs
    def matrix4_f64():
        # matrix4, float64: the band-limit, the envelopes, the engine, the audio
        e, st, x = upmix_streams("matrix4 -6", f64, S8)
        bl = tuple(e.device_array(k, x) for k in ("A_bl", "B_bl", "c0_bl"))
        _, y_bp = iir.biquad_scan_series(*bl, st["bp_m"], x)
        env_m, env_ds = m4.m4_env(y_bp, st["env_m"], e.g_env)
        ev_out = m4.m4_event(e.ctl, st["ev"], st["bg_cs"], env_ds, st["interp_y"], 0, False)
        L = e.ctl.p["buf_len"]
        form("biquad_scan_series@S", "biquad_scan_series@S (matrix4's band-limit, B=2048)",
             lambda s_, x_: iir.biquad_scan_series(*bl, s_, x_),
             lambda s_, x_: iir.biquad_scan_series_ref(*bl, s_, x_),
             maker(st["bp_m"], x), (0, 1), kernels.biquad_run_launches,
             lambda S: (8 * S * (2 * B * C + 8 * C) + 8 * 14 * C, 20 * B * C * S, F64_PEAK))
        form("m4_env@S", "m4_env@S (B=2048, a lane a stream)",
             lambda y_, m_: m4.m4_env(y_, m_, e.g_env), lambda y_, m_: m4.m4_env_ref(y_, m_, e.g_env),
             maker(y_bp, st["env_m"]), (0, 1), kernels.lookback_launches,
             lambda S: (S * (16 * B + 128 + 64 * Nc), 8 * 3 * B * S, F64_PEAK), hold=rel_env(1e-12))
        form("m4_event@S", "m4_event@S (Nc=64, v4, the streams the engine's lanes)",
             lambda *a: m4.m4_event(e.ctl, *a, 0, False),
             lambda *a: m4.m4_event_ref(e.ctl, *a, 0, False),
             maker(st["ev"], st["bg_cs"], env_ds, st["interp_y"], lane=True), streamed(4, True),
             kernels.upmix_launches,
             lambda S: (S * (2 * 8 * (80 + 10 * L) + 64 * Nc + 8 * Nc * (48 + 4) + 2 * 512),
                        (300 + 250 + 112) * Nc * S, F64_PEAK),
             hold=hold_event(1e-12), lane=True, reps=20, plain_streams=FORM_STREAMS)
        n_in, n_out = CHANNELS, e.audio.n_out
        form("m4_audio@S", "m4_audio@S (B=2048, v4, a block a stream)",
             lambda *a: m4.m4_audio(e.audio, *a), lambda *a: m4.m4_audio_ref(e.audio, *a),
             maker(x, st["buf"], st["interp_c"], ev_out[2], st["shelf_m"], st["lp_m"], st["pf_m"]),
             streamed(7), kernels.upmix_launches,
             lambda S: (8 * S * (B * (n_in + n_out) + 2 * e.len + 48 * (Nc + 1) + 32),
                        (40 + 12 + 64 + 10) * B * S, F64_PEAK), hold=hold_abs(-280.0), reps=20)

    def matrix4_f32():
        # matrix4, float32: K1-df's (hi, lo) band-limit feeds the float32 forms
        e, st, x = upmix_streams("matrix4 -6", f32, S8)
        _, (hi, lo) = iir.lti_blocked_df(e._bp_plan(B), st["bpc"], x)
        env_out = m4.m4_env_f32(hi, lo, st["env_m"], st["env_m_lo"], e.g_env)
        ev_out = m4.m4_event_f32(e.ctl, st["ev"], st["ev_lo"], st["bg_cs"], st["bg_cs_lo"],
                                 env_out[2], st["interp_y"], 0, False)
        L, n_in, n_out = e.ctl.p["buf_len"], CHANNELS, e.audio.n_out
        form("m4_env_f32@S", "m4_env_f32@S (B=2048, a lane a stream)",
             lambda *a: m4.m4_env_f32(*a, e.g_env), lambda *a: m4.m4_env_f32_ref(*a, e.g_env),
             maker(hi, lo, st["env_m"], st["env_m_lo"]), (0, 1, 2, 3), kernels.lookback_launches,
             lambda S: (S * (16 * B + 128 + 64 * Nc), (8 * 3 * B + 4 * B) * S, F64_PEAK),
             hold=rel_env(M4_F32_REL))
        form("m4_event_f32@S", "m4_event_f32@S (Nc=64, v4, the streams the engine's lanes)",
             lambda *a: m4.m4_event_f32(e.ctl, *a, 0, False),
             lambda *a: m4.m4_event_f32_ref(e.ctl, *a, 0, False),
             maker(st["ev"], st["ev_lo"], st["bg_cs"], st["bg_cs_lo"], env_out[2], st["interp_y"],
                   lane=True), streamed(6, True), kernels.upmix_launches,
             lambda S: (S * (2 * 8 * (80 + 10 * L) + 64 * Nc + 4 * Nc * (48 + 4) + 2 * 256),
                        (300 + 250 + 112) * Nc * S, F64_PEAK),
             hold=hold_engine_f32(M4_F32_REL), lane=True, reps=20, plain_streams=FORM_STREAMS)
        form("m4_audio_f32@S", "m4_audio_f32@S (B=2048, v4, a block a stream)",
             lambda *a: m4.m4_audio_f32(e.audio, *a), lambda *a: m4.m4_audio_f32_ref(e.audio, *a),
             maker(x, st["buf"], st["interp_c"], ev_out[4], st["shelf_m"], st["lp_m"], st["pf_m"]),
             streamed(7), kernels.upmix_launches,
             lambda S: (4 * S * (B * (n_in + n_out) + 2 * e.len + 48 * (Nc + 1) + 32),
                        (40 + 12 + 64 + 10) * B * S, F64_PEAK), hold=hold_ulp, reps=20)

    def matrix4_mb(dt):
        # matrix4_mb: the fshape and the bank (stream-ready) give the bands
        G = m4.N_BANDS
        sfx = "_f32" if dt == f32 else ""
        e, st, x = upmix_streams("matrix4_mb -6", dt, S8)
        _, s_pre = e._cascade("fsh", st["fshape_m"].reshape(S8, 2, 2, 2), x)
        xt = s_pre.repeat(1, 1, G)
        if dt == f64:
            _, yb = iir.lti_blocked(e._bank_plan(B), st["bank"]["fused"], xt)
            bands = (yb.view(S8, B, G, 2),)
            env_args, env_n = bands + (st["env_m"],), 2
        else:
            _, (hi, lo) = iir.lti_blocked_df(e._bank_plan(B), st["bank"]["fused"], xt)
            bands = (hi.view(S8, B, G, 2), lo.view(S8, B, G, 2))
            env_args, env_n = bands + (st["env_m"], st["env_m_lo"]), 4
        env_fn = getattr(m4, f"m4mb_env{sfx}")
        env_ref = getattr(m4, f"m4mb_env{sfx}_ref")
        w8 = 8 if dt == f64 else 4
        mask = torch.as_tensor(m4.band_mix_weights(0.5), device="cuda")
        env_out = env_fn(*env_args, e.g_env)
        rel_mb = MB_F32_REL if dt == f32 else 1e-13
        for w, rec in ((None, f"m4mb_env{sfx}@S"), (mask, None)):
            form(rec, f"m4mb_env{sfx}@S (B=2048, 13 lanes a stream"
                      f"{', the mask 0.5' if w is not None else ''})",
                 lambda *a, w=w: env_fn(*a, e.g_env, w), lambda *a, w=w: env_ref(*a, e.g_env, w),
                 maker(*env_args), tuple(range(env_n)), kernels.lookback_launches,
                 lambda S: (S * 8 * (2 * B * G + 2 * 8 * G + 8 * Nc * G),
                            (8 * 3 * B * G + (4 * B * G if dt == f32 else 0)) * S, F64_PEAK),
                 hold=rel_env(rel_mb))
        Lr = e.ctl.p["buf_len"]
        if dt == f64:
            ev_args = (st["ev"], st["ev_thresh"], env_out[1], st["interp_y"])
            hold = hold_event(1e-13)
        else:
            ev_args = (st["ev"], st["ev_lo"], st["ev_thresh"], st["ev_thresh_lo"], env_out[2],
                       st["interp_y"])
            hold = hold_engine_f32(MB_F32_REL)
        ev_fn, ev_ref = getattr(m4, f"m4mb_event{sfx}"), getattr(m4, f"m4mb_event{sfx}_ref")
        ev_out = ev_fn(e.ctl, *ev_args, 0, False)
        form(f"m4mb_event{sfx}@S", f"m4mb_event{sfx}@S (Nc=64, v4, 13 bands, a block a stream)",
             lambda *a: ev_fn(e.ctl, *a, 0, False), lambda *a: ev_ref(e.ctl, *a, 0, False),
             maker(*ev_args), streamed(len(ev_args)), kernels.upmix_launches,
             lambda S: (S * (8 * (2 * G * (80 + 10 * Lr) + 2 * G + 8 * Nc * G + 2 * 4 * G * 12)
                             + w8 * (3 * Nc * G * 12 + 2 * Nc * G)),
                        ((300 + 156 + 250) * G * Nc + 7 * G * 12 * Nc) * S, F64_PEAK),
             hold=hold, reps=20, plain_streams=FORM_STREAMS)
        au_fn, au_ref = getattr(m4, f"m4mb_audio{sfx}"), getattr(m4, f"m4mb_audio{sfx}_ref")
        form(f"m4mb_audio{sfx}@S", f"m4mb_audio{sfx}@S (B=2048, v4, tiles of each stream)",
             lambda *a: au_fn(e.audio, *a), lambda *a: au_ref(e.audio, *a),
             maker(bands[0], st["fb_buf"], st["interp_c"], ev_out[2 if dt == f64 else 4],
                   st["pf_m"]), streamed(5), kernels.lookback_launches,
             lambda S: (S * w8 * (2 * B * G + 2 * min(B, e.fb_buf_len) * G + 3 * (Nc + 1) * G * 12
                                  + 2 * 4 * G + 4 * B), (48 + 12 + 10 + 6) * G * B * S, F64_PEAK),
             hold=hold_abs(MB_AUDIO_DBFS) if dt == f64 else hold_ulp, reps=20)

    matrix4_f64()
    matrix4_f32()
    for dt in (f64, f32):
        matrix4_mb(dt)


# slice H2b: the time-domain effects' kernels with a stream axis, the
# stream-axis rows of split_kernel_phase (record, the wrapper whose own
# count is the row's launches: a stats row's -i launches are its wrapper's
# less its plain mode's), counted in batch_td_phase
TD_FORMS = (
    ("tpdf_noise@S", "tpdf_noise"), ("tpdf_noise_f32@S", "tpdf_noise_f32"),
    ("tpdf_dither@S", "tpdf_dither"), ("tpdf_dither_f32@S", "tpdf_dither_f32"),
    ("stats_step@S", "stats_step"), ("stats_step_f32@S", "stats_step_f32"),
    ("stats_step_plain@S", "stats_step.plain"),
    ("stats_step_plain_f32@S", "stats_step_f32.plain"),
    ("levels_step@S", "levels_step"), ("levels_step_f32@S", "levels_step_f32"),
    ("mod_delay@S", "mod_delay"), ("mod_delay_f32@S", "mod_delay_f32"),
)
# process_batch of the delivery and modulated chains: seconds a stream (the
# streams are BATCH_STREAMS) and the blocks
TD_BATCH_SECONDS = 20
TD_BATCH_BLOCKS = (2048, 65536)


def _td_wrappers():
    """The five wrappers of ops/time_domain.py in both dtypes."""
    from dsp_tpu_torch.ops import time_domain as td

    return [getattr(td, f"{name}{sfx}") for name in (
        "tpdf_noise", "tpdf_dither", "stats_step", "levels_step", "mod_delay")
        for sfx in ("", "_f32")]


def _td_counts():
    """{record: launches} of TD_FORMS by the wrappers' own counts."""
    from dsp_tpu_torch.ops import time_domain as td

    out = {}
    for rec, w in TD_FORMS:
        name, _, mode = w.partition(".")
        fn = getattr(td, name)
        if mode:
            out[rec] = fn.plain.launches
        elif name.startswith("stats"):
            out[rec] = fn.launches - fn.plain.launches
        else:
            out[rec] = fn.launches
    return out


def _td_zero():
    for w in _td_wrappers():
        w.launches = 0
        if hasattr(w, "plain"):
            w.plain.launches = 0


def td_forms(form):
    """The time-domain effects' stream-axis forms for split_kernel_phase, in
    float64 and float32, stereo at B = 2048: K18 (tpdf_noise) with every
    channel and with the first only, K15 (tpdf_dither) lipshitz, flat and
    sloped2 at 16 bits, K16 (stats_step) -i and plain, K17 (levels_step)
    and K14 (mod_delay) at q0 and q2, -m and -M (0.5 ms depth, a 1 kHz
    modulator). Each stream's state comes from a one-stream run of its own
    seed and length (1, 2, 3 blocks), so the keys, error histories, noise
    carries, sums, meters, phases, knot windows and lines all differ by
    stream; stats' samples too, and stream 1's limit falls inside the block.
    S = TIMED_STREAMS takes those streams in turn. The plain version is the
    wrapper on host copies, which runs its plain version a stream at a time.
    Held at the one-stream rows' tolerances (time_domain_phase,
    float32_time_domain_phase): noise and dither bit-equal; stats' sums
    within 1e-12 relative (float32: one ulp of their scale), every other
    leaf bit-equal; levels within 1e-12 relative (one ulp); the modulated
    read within MOD_DELAY_DBFS (one ulp), its key and line bit-equal (and,
    in float32, its knots and phase). The first form of each kernel and
    dtype is its timed row (the main path's form)."""
    import numpy as np
    import torch

    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.core.prng import prng_key
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.delay import ModDelayEffect
    from dsp_tpu_torch.effects.dither import DitherEffect
    from dsp_tpu_torch.effects.stats import StatsEffect
    from dsp_tpu_torch.ops import time_domain as td

    dev = torch.device("cuda")
    rng = np.random.default_rng(20320)
    f64, f32 = torch.float64, torch.float32
    B, C, S3 = 2048, CHANNELS, FORM_STREAMS
    ones = np.ones(C, dtype=bool)

    def normal(dt, *shape, scale=0.3):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=dt, device=dev)

    def stack(items):
        """One-stream results (tensors, or tuples or dicts of them) stacked
        into stream-axis leaves."""
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([it[k] for it in items]) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(stack([it[i] for it in items]) for i in range(len(first)))
        return torch.stack(items).contiguous()

    def cycle(a, S):
        """Streams s % S3 of a (a tensor led by S3, or a dict of them) for
        s < S; S = 0: stream 0 alone, without the axis."""
        if isinstance(a, dict):
            return {k: cycle(v, S) for k, v in a.items()}
        if not S:
            return a[0]
        idx = torch.arange(S, device=a.device) % S3
        if a.dtype == torch.uint32:  # the keys: CUDA indexes no uint32 tensor
            return a.view(torch.int32)[idx].view(torch.uint32)
        return a[idx].contiguous()

    def maker(n, *args):
        """make(S): the first n args (led by S3 streams) cycled to S, the
        rest (the effect's constants) as they are."""
        return lambda S: tuple(cycle(a, S) if i < n else a for i, a in enumerate(args))

    def on_host(call):
        return lambda *a: call(*_to_cpu(a))

    def hold_bits(got, ref):
        for k, (a, b) in enumerate(zip(_leaves(got), _leaves(ref))):
            _require(f"output {k} differs from the plain version", bits_equal(a, b))
        return 0.0

    def within(a, b, f32_, rel=1e-12, floor=0.0, what="output"):
        """a against b: one float32 ulp of b's scale, or rel of max(floor,
        max |b|); returns max |a - b|."""
        if f32_:
            ulps, err = _ulps(a, b)
            _require(f"{what} {ulps:.2f} ulp of its scale from the plain version", ulps <= 1.0)
        else:
            err = _diff(a, b)
            _require(f"{what} {err:.3e} from the plain version",
                     err <= rel * max(floor, float(b.abs().max())))
        return err

    def hold_stats(f32_):
        def hold(got, ref):
            err = 0.0
            for k in ref:
                if k in ("sum", "sum_sq"):
                    err = max(err, within(got[k], ref[k], f32_, floor=1.0, what=k))
                else:
                    _require(f"{k} differs from the plain version", bits_equal(got[k], ref[k]))
            return err
        return hold

    def hold_levels(f32_):
        def hold(got, ref):
            return max(within(a, b, f32_, what=k)
                       for k, a, b in zip(("avg", "peak", "block_peak"), got, ref))
        return hold

    def hold_delay(f32_):
        def hold(got, ref):
            # (key', knots, phase, y, line')
            exact = (0, 1, 2, 4) if f32_ else (0, 4)
            err = 0.0
            for k, (a, b) in enumerate(zip(got, ref)):
                if k in exact:
                    _require(f"output {k} differs from the plain version", bits_equal(a, b))
                elif f32_:
                    err = max(err, within(a, b, True, what="y"))
                else:
                    e = _diff(a, b)
                    _require(f"output {k} {dbfs(e):.1f} dBFS from the plain version",
                             dbfs(e) <= MOD_DELAY_DBFS)
                    err = max(err, e)
            return err
        return hold

    def noise(dt):
        sfx, es, peak = ("_f32", 4, F32_PEAK) if dt == f32 else ("", 8, F64_PEAK)
        entry = getattr(td, f"tpdf_noise{sfx}")
        mult = 10.0 ** (-90 / 20) / 0x7FFFFFFF  # noise -90
        keys = []
        for s in range(S3):
            k = prng_key(987000 + 17 * s).to(dev)
            for _ in range(1 + s):
                k, _ = entry(k, normal(dt, B, C), mult)
            keys.append(k)
        keys, x = stack(keys), normal(dt, S3, B, C)

        def call(k, x_, sel):
            return entry(k, x_, mult, sel)

        for sel, rec in ((None, f"tpdf_noise{sfx}@S"),
                         (torch.tensor([True, False], device=dev), None)):
            form(rec, f"tpdf_noise{sfx}@S (B=2048, "
                      f"{'every channel' if sel is None else 'the first channel'})",
                 call, on_host(call), maker(2, keys, x, sel), (0, 1), kernels.noise_launches,
                 # x in, y out, the keys; 3 operations a sample
                 lambda S: (S * (2 * es * B * C + 16), 3 * B * C * S, peak),
                 hold=hold_bits, plain_streams=FORM_STREAMS)

    def dither(dt):
        sfx, es, peak = ("_f32", 4, F32_PEAK) if dt == f32 else ("", 8, F64_PEAK)
        entry = getattr(td, f"tpdf_dither{sfx}")
        for shape in ("lipshitz", "flat", "sloped2"):
            e = DitherEffect("dither", StreamInfo(FS, C), ones, shape, 16.0, 16, False, False,
                             seed=4242)
            consts = tuple(torch.as_tensor(v, dtype=None if v.dtype == bool else dt, device=dev)
                           for v in (e.n_mult, e.q_mult0, e.q_mult1, e.enabled, e.fir))
            sts = []
            for s in range(S3):
                st = (prng_key(4242 + 31 * s).to(dev), normal(dt, 9, C, scale=1e-5),
                      torch.as_tensor(rng.uniform(0, 0x7FFFFFFF, C), dtype=dt, device=dev))
                for _ in range(1 + s):
                    st = entry(st[0], normal(dt, B, C), st[1], st[2], *consts, e.mode)[:3]
                sts.append(st)
            key, eh, npv = stack(sts)

            def call(k, x_, eh_, np_, *c, mode=e.mode):
                return entry(k, x_, eh_, np_, *c, mode)

            form(f"tpdf_dither{sfx}@S" if shape == "lipshitz" else None,
                 f"tpdf_dither{sfx}@S ({shape}, 16 bits, B=2048)",
                 call, on_host(call), maker(4, key, normal(dt, S3, B, C), eh, npv, *consts),
                 (0, 1, 2, 3), kernels.dither_launches,
                 # x in, y out, the states, the constants; 2 operations a
                 # sample for the noise, 23 for the 9-tap feedback quantizer
                 lambda S: (S * (2 * es * B * C + es * 20 * C + 16) + es * (3 * C + 9) + C,
                            25 * B * C * S, peak),
                 hold=hold_bits, plain_streams=FORM_STREAMS)

    def stats(dt):
        sfx, es, peak = ("_f32", 4, F32_PEAK) if dt == f32 else ("", 8, F64_PEAK)
        entry = getattr(td, f"stats_step{sfx}")
        kinds = ("noise", "gate-sparse", "click")
        for interp in (True, False):
            e = StatsEffect("stats", StreamInfo(FS, C), ones, None, 80, interp)
            table = torch.as_tensor(e._insert_table, dtype=dt, device=dev) if interp else None
            sts = []
            for s in range(S3):
                st = {k: torch.as_tensor(v, device=dev) for k, v in e.state0().items()}
                st = {k: v.to(dt) if v.is_floating_point() else v for k, v in st.items()}
                for _ in range(1 + s):
                    st = entry(st, torch.as_tensor(td_signal(kinds[s], B, rng), dtype=dt,
                                                   device=dev), table)
                sts.append(st)
            st = stack(sts)
            st["limit"][1] = int(st["samples"][1]) + 700  # inside the next block
            x = torch.as_tensor(np.stack([td_signal(kinds[s], B, rng) for s in range(S3)]),
                                dtype=dt, device=dev)
            gated = []  # the -i gate's samples, by stream, in the plain call

            def plain(st_, x_, tb, gated=gated):
                outs = []
                for s in range(x_.shape[0]):
                    outs.append(entry(_to_cpu(_pick(st_, s)), x_[s].cpu(), _to_cpu(tb)))
                    gated.append(td.stats_step_ref.gated_samples)
                return stack(outs)

            # the accumulators, 4 operations a sample; -i, a gated sample
            # (counted on these inputs) adds 134 for the buffer and direct
            # taps and 4 fits of about 12
            state = es * 5 * C + 8 * (2 * C + 2) + (es * C * 81 + 4 * C if interp else 0)
            form(f"stats_step{'' if interp else '_plain'}{sfx}@S",
                 f"stats_step{sfx}@S ({'-i' if interp else 'plain'}, B=2048, inputs "
                 f"{', '.join(kinds)}, a limit in stream 1)",
                 entry, plain, maker(2, st, x, table), {0: _pick, 1: None},
                 lambda: kernels.meter_launches()[0],
                 lambda S, interp=interp, state=state, gated=gated: (
                     S * (es * B * C + 2 * state) + (es * 67 if interp else 0),
                     4 * B * C * S + 182 * sum(gated[s % S3] for s in range(S)), peak),
                 hold=hold_stats(dt == f32), plain_streams=FORM_STREAMS)

    def levels(dt):
        sfx, es, peak = ("_f32", 4, F32_PEAK) if dt == f32 else ("", 8, F64_PEAK)
        entry = getattr(td, f"levels_step{sfx}")
        g = 1.0 - math.exp(-1.0 / (FS * 0.3))
        sts = []
        for s in range(S3):
            st = tuple(torch.as_tensor(rng.uniform(0, 0.1, C), dtype=dt, device=dev)
                       for _ in range(3))
            for _ in range(1 + s):
                st = entry(*st, normal(dt, B, C), g)
            sts.append(st)
        st = stack(sts)

        def call(*a):
            return entry(*a, g)

        form(f"levels_step{sfx}@S", f"levels_step{sfx}@S (B=2048)", call, on_host(call),
             maker(4, *st, normal(dt, S3, B, C)), (0, 1, 2, 3), lambda: kernels.meter_launches()[1],
             lambda S: (S * es * (B * C + 6 * C), 6 * B * C * S, peak),
             hold=hold_levels(dt == f32), plain_streams=FORM_STREAMS)

    def mod_delay(dt):
        sfx, es, peak = ("_f32", 4, F32_PEAK) if dt == f32 else ("", 8, F64_PEAK)
        entry = getattr(td, f"mod_delay{sfx}")
        sel = torch.ones(C, dtype=torch.bool, device=dev)
        for qual, mono in ((2, True), (0, True), (2, False), (0, False)):
            e = ModDelayEffect("delay", StreamInfo(FS, C), ones, 0.5e-3 * FS, 1000.0, mono, qual,
                               seed=31337)
            table = None if e.table is None else torch.as_tensor(e.table, dtype=dt, device=dev)
            sts = []
            for s in range(S3):
                e.seed = 31337 + 13 * s
                st = {k: torch.as_tensor(v, dtype=dt if np.asarray(v).dtype.kind == "f" else None,
                                         device=dev) for k, v in e.state0().items()}
                for _ in range(1 + s):
                    st = e.step(st, normal(dt, B, C))[0]
                sts.append((st["key"], st["y"], st["t"], st["buf"]))
            key, yk, t, buf = stack(sts)
            H = buf.shape[-2]

            def call(k, yk_, t_, buf_, x_, sel_, tb, e=e):
                return entry(k, yk_, t_, buf_, x_, sel_, tb, e.depth, e.step_size, e.n_taps,
                             e.qual)

            taps = e.n_taps
            form(f"mod_delay{sfx}@S" if (qual, mono) == (2, True) else None,
                 f"mod_delay{sfx}@S (q{qual} {'-M' if mono else '-m'}, 0.5 ms, 1 kHz, B=2048)",
                 call, on_host(call), maker(5, key, yk, t, buf, normal(dt, S3, B, C), sel, table),
                 (0, 1, 2, 3, 4), kernels.mod_delay_launches,
                 # x and the line in, y and the line out, the table; the
                 # B-spline (~20), 4 x taps multiply-adds and the join (~15)
                 # a sample
                 lambda S, H=H, taps=taps, table=table: (
                     S * es * (2 * B * C + 2 * H * C) + 80 * S
                     + (0 if table is None else es * table.numel()),
                     (20 + 8 * taps + 15) * B * C * S, F64_PEAK),
                 hold=hold_delay(dt == f32), plain_streams=FORM_STREAMS)

    for dt in (f64, f32):
        noise(dt)
        dither(dt)
        stats(dt)
        levels(dt)
        mod_delay(dt)


def batch_td_phase(records):
    """Slice H2b on the card: process_batch on BATCH_STREAMS streams of
    TD_BATCH_SECONDS s of noise and sines (each its own seed) of the
    delivery chain (its dither enabled at 16 bits, as the CLI's s16 writer
    enables it) and the modulated chain at each block of TD_BATCH_BLOCKS,
    float64 and float32, numpy's generator seeded before each chain is
    built (the effects draw their keys from it): each stream bit-equal to
    process_array of that stream from the same live state on the card, and
    the kernels a host step equal at S = 1 and S = 8 (each kernel one
    launch for the 8). The batch's seconds of audio a wall second against
    process_array's (one stream) are printed, after a short batch that
    warms the chain; in float64 at 2048 also the batch's parts
    (batch_parts) at S = 1 and 8. Each time-domain stream-axis row counts
    the launches of the batches alone (the wrappers' counts set to 0 just
    before a batch and read just after), and every row must have run."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_args
    from dsp_tpu_torch.chain.chain import chain_set_dither_params
    from dsp_tpu_torch.core.types import StreamInfo

    for rec, _ in TD_FORMS:
        records[rec]["launches"] = 0
    S = BATCH_STREAMS

    def add():
        for rec, c in _td_counts().items():
            records[rec]["launches"] += c

    def run(words, B, dt, xs, label):
        np.random.seed(SLICE_C_SEED)
        chain = build_chain_from_args(words.split(), StreamInfo(FS, CHANNELS))
        chain_set_dither_params(chain, 16, True)
        cc = CompiledChain(chain, B, dtype=dt, device="cuda")
        batch_check(cc, xs, label, _td_zero, add, parts=B == 2048 and dt == torch.float64)

    print(f"process_batch of the delivery and modulated chains: {S} streams of "
          f"{TD_BATCH_SECONDS} s")
    n = TD_BATCH_SECONDS * FS
    rng = np.random.default_rng(90)
    t = np.arange(n)[:, None] / FS
    xs = np.stack([0.2 * rng.standard_normal((n, CHANNELS))
                   + 0.3 * np.sin(2 * np.pi * np.array([40.0, 1000.0]) * (1 + 0.1 * s) * t)
                   for s in range(S)])
    for label, words in (("delivery", DELIVERY), ("modulated", MODULATED)):
        for B in TD_BATCH_BLOCKS:
            for dt in (torch.float64, torch.float32):
                run(words, B, dt, xs, f"{label} -b {B} {str(dt)[6:]}")
    idle = [rec for rec, _ in TD_FORMS if records[rec]["launches"] == 0]
    _require(f"time-domain stream-axis rows never launched in the batches: {idle}", not idle)
    print("time-domain stream-axis launches in the batches: "
          + ", ".join(f"{rec} {records[rec]['launches']}" for rec, _ in TD_FORMS))


def batch_parts(cc, xs):
    """Wall seconds of the parts of a batch of xs (numpy [S, n, C], the
    streams; S = 1 is process_array's route) on cc from its live state:
    (the host's padding and the copy to the card, the steps to a
    synchronisation, the copy back), as process_batch runs them."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain.chain import expected_out_frames

    S, n_in, c = xs.shape
    B = cc.block_frames
    out_valid = expected_out_frames(cc.chain, n_in, True)
    nb = max(1, -(-(n_in + cc.chain.drain_frames) // B), -(-out_valid // int(B * cc.chain.ratio)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = np.zeros((S, nb * B, c))
    flat[:, :n_in] = xs
    xd = cc._input(flat).view(S, nb, B, c).transpose(0, 1).contiguous()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    states = cc._stream_states(cc.states, S) if S > 1 else cc.states
    ys = []
    for i in range(nb):
        states, y = cc._step(states, xd[i] if S > 1 else xd[i, 0])
        ys.append(y)
    y = torch.stack(ys, dim=-3)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    y = y.reshape(*y.shape[:-3], -1, y.shape[-1])[..., cc.chain.output_discard:out_valid, :]
    y.to("cpu", torch.float64).numpy()
    return t1 - t0, t2 - t1, time.perf_counter() - t2


def _clone(tree):
    """A state tree with every tensor copied."""
    import torch

    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def batch_check(cc, xs, label, zero, add, parts=False):
    """process_batch(xs) (numpy [S, n, C]) on cc, after a short batch that
    warms the chain (its tables at this block, the allocator's buffers are
    not the batch's time), against process_array of each stream from the
    same live state, on the card: each stream bit-equal, and the kernels a
    host step (kernel_total) equal at S = 1 and S (each kernel one launch
    for the S). zero() runs just before the batch and add() just after it
    (the rows' launches of the batch alone). Prints the batch's seconds of
    audio a wall second against process_array's and, with parts, where the
    time goes (batch_parts) at S = 1 and S."""
    import numpy as np
    import torch

    live = _clone(cc.states)
    cc.process_batch(xs[:, :2 * cc.block_frames])
    per, walls = [], []
    steps, restore = _counting_steps()
    try:
        zero()
        torch.cuda.synchronize()
        k0, t0 = kernel_total(), time.perf_counter()
        yb = cc.process_batch(xs)
        walls.append(time.perf_counter() - t0)
        per.append((kernel_total() - k0) / steps[0])
        add()
        for s in range(len(xs)):
            cc.states = _clone(live)
            steps[0] = 0
            torch.cuda.synchronize()
            k0, t0 = kernel_total(), time.perf_counter()
            one = cc.process_array(xs[s])
            walls.append(time.perf_counter() - t0)
            per.append((kernel_total() - k0) / steps[0])
            _require(f"process_batch {label}: stream {s} differs from process_array on the "
                     f"card", np.array_equal(yb[s], one))
    finally:
        restore()
    _require(f"process_batch {label}: {per[0]:.3f} kernels a host step at S={len(xs)}, "
             f"{per[1]:.3f} at S=1", per[0] == per[1] and len(set(per[1:])) == 1)
    if parts:
        for n in (1, len(xs)):
            cc.states = _clone(live)
            p = batch_parts(cc, xs[:n])
            print(f"  {label} S={n}: the batch's parts {p[0]:.3f} s in, {p[1]:.3f} s of steps, "
                  f"{p[2]:.3f} s out")
    secs = xs.shape[1] / cc.chain.istream.fs
    print(f"  {label}: {walls[0]:.3f} s for the batch of {len(xs)} "
          f"({len(xs) * secs / walls[0]:.1f} s of audio a second, "
          f"{secs / walls[0]:.1f}x realtime a stream); process_array "
          f"{np.mean(walls[1:]):.3f} s a stream ({secs / np.mean(walls[1:]):.1f}x); the "
          f"batch {len(xs) * np.mean(walls[1:]) / walls[0]:.2f}x the streams' rate one by "
          f"one; {per[0]:.3f} kernels a host step at S={len(xs)} and 1; every stream "
          f"bit-equal")


def batch_upmix_phase(records):
    """Slice H2a on the card: process_batch on BATCH_STREAMS streams of
    UPMIX_BATCH_SECONDS s of transients (each its own seed) of `matrix4
    -6` and `matrix4_mb -6` at each block of UPMIX_BATCH_BLOCKS, float64
    and float32: each stream bit-equal to process_array of that stream on
    the card, and the kernels a host step equal at S = 1 and S = 8 (each
    kernel one launch for the 8). The batch's seconds of audio a wall
    second against process_array's (one stream) are printed, after a short
    batch that warms the chain; in float64 at 44.1 kHz also the batch's
    parts (batch_parts) at S = 1 and 8. Then RING_PROBE: matrix4_mb at
    470.4 kHz on 2 streams, where the engine's rings sit in the device
    scratch, in both dtypes, bit-equal to process_array. Each upmix
    stream-axis form's row counts the launches of the batches alone (its
    wrapper's count set to 0 just before a batch and read just after), and
    every form must have run."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops import m4_engine as m4

    wrappers = _upmix_wrappers()
    for rec in wrappers:
        records[rec]["launches"] = 0
    S = BATCH_STREAMS

    def zero():
        for w in wrappers.values():
            w.launches = 0

    def add():
        for rec, w in wrappers.items():
            records[rec]["launches"] += w.launches

    def run(words, fs, B, dt, xs, label):
        cc = CompiledChain(build_chain_from_string(words, StreamInfo(fs, CHANNELS)), B,
                           dtype=dt, device="cuda")
        batch_check(cc, xs, label, zero, add, parts=fs == FS and dt == torch.float64)
        return cc

    print(f"process_batch of the upmixes: {S} streams of {UPMIX_BATCH_SECONDS} s of transients")
    n = UPMIX_BATCH_SECONDS * FS
    xs = np.stack([transient_signal(UPMIX_BATCH_SECONDS, seed=70 + s)[:n] for s in range(S)])
    for words in ("matrix4 -6", "matrix4_mb -6"):
        for B in UPMIX_BATCH_BLOCKS:
            for dt in (torch.float64, torch.float32):
                run(words, FS, B, dt, xs, f"{words} -b {B} {str(dt)[6:]}")
    words, fs, S_r, secs = RING_PROBE
    xs = np.stack([transient_signal(secs, fs, seed=80 + s) for s in range(S_r)])
    for dt in (torch.float64, torch.float32):
        cc = run(words, fs, 2048, dt, xs, f"{words} at {fs} Hz, {S_r} streams, {str(dt)[6:]}")
        e = next(e for e in cc._runtime_effects if hasattr(e, "ctl"))
        geo = m4.event_geometry(m4.N_BANDS, e.ctl.p["buf_len"], 2048 // 32)
        _require(f"{words} at {fs} Hz: the rings are not in the device scratch", geo[3] > 0)
    idle = [rec for rec in wrappers if records[rec]["launches"] == 0]
    _require(f"upmix stream-axis forms never launched in the batches: {idle}", not idle)
    print("upmix stream-axis launches in the batches: "
          + ", ".join(f"{rec} {records[rec]['launches']}" for rec in wrappers))


# slice H2c: process_batch across a list of devices, here two groups on the
# one card (no run here can show two cards); (label, chain, block, dtype)
# on DEVICES_STREAMS streams of DEVICES_SECONDS s, each its own seed
DEVICES = ("cuda:0", "cuda:0")
DEVICES_STREAMS = 8
DEVICES_SECONDS = 20
DEVICES_CASES = (
    ("flagship", FLAGSHIP, 2048, "float64"),
    ("flagship", FLAGSHIP, 65536, "float64"),
    ("MC_CHAIN", None, 2048, "float64"),  # None: dsp_tpu_torch.dryrun.MC_CHAIN
    ("MC_CHAIN", None, 65536, "float64"),
    ("modulated", MODULATED, 2048, "float64"),
    ("flagship", FLAGSHIP, 2048, "float32"),
)
# a real replica on a second device: the float64 cases at -b 2048 with one
# group on the card and one on the CPU, the chain built on either, on
# MIXED_FRAMES frames of the same streams (the CPU group runs the plain
# versions: matrix4's event engine there is a Python loop a tick)
MIXED_DEVICES = (("cuda", ("cuda:0", "cpu")), ("cpu", ("cpu", "cuda:0")))
MIXED_FRAMES = 16384


def mixed_devices_check(what, words, B, xs):
    """process_batch(xs, devices=...) for each of MIXED_DEVICES, the chain
    built on its home device (numpy's generator seeded alike before each
    build), each group's rows held to the card's one-group batch within
    LIMIT_DBFS. The kernels launched (kernel_total, zeroed just before the
    run, read just after) must equal the one-group batch's: the card group
    launches every kernel of the step once a block, the CPU group none."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    def built(device):
        np.random.seed(SLICE_C_SEED)
        return CompiledChain(build_chain_from_string(words, StreamInfo(FS, CHANNELS)), B,
                             device=device)

    k0 = kernel_total()
    one = built("cuda").process_batch(xs)
    k1 = kernel_total() - k0
    k = len(xs) // 2
    for home, devices in MIXED_DEVICES:
        cc = built(home)
        k0 = kernel_total()
        y = cc.process_batch(xs, devices=list(devices))
        torch.cuda.synchronize()
        launched = kernel_total() - k0
        errs = [dbfs(float(np.abs(y[g * k:(g + 1) * k] - one[g * k:(g + 1) * k]).max()))
                for g in range(2)]
        print(f"  {what}, chain on {home}, devices {list(devices)}: groups vs one group on the "
              f"card {errs[0]:.1f} and {errs[1]:.1f} dBFS (limit {LIMIT_DBFS}); kernels {launched} "
              f"(one group's {k1})")
        _require(f"devices {what} on {list(devices)}: {y.shape} against {one.shape}, or not finite",
                 y.shape == one.shape and np.isfinite(y).all())
        _require(f"devices {what} on {list(devices)}: {errs} dBFS", max(errs) <= LIMIT_DBFS)
        _require(f"devices {what} on {list(devices)}: kernels {launched}, one group's {k1}",
                 k1 > 0 and launched == k1)


def devices_phase():
    """Slice H2c on the card: process_batch(xs, devices=DEVICES), two groups
    of 4 streams stepped in turn from one thread, against devices=None (one
    group of 8), on DEVICES_STREAMS streams of DEVICES_SECONDS s of noise
    and sines (each its own seed) for each case of DEVICES_CASES, numpy's
    generator seeded before each chain is built (the modulated chain's
    noise and dither draw their keys from it: every group starts from the
    live key). Each case: a short warming batch on both routes, then one
    group and two groups in turns (one, two, two, one), each output bit-equal
    to the first one-group output, and each two-group run's kernels (the
    libraries' counts, kernel_total) twice the one-group run's: each group
    launches every kernel of the step once a block. Prints both routes'
    wall seconds. The float64 cases at -b 2048 then run a real replica
    (mixed_devices_check). Then the port's dry run (dryrun_multidevice) on
    DEVICES."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.dryrun import MC_CHAIN, dryrun_multidevice

    S, n = DEVICES_STREAMS, DEVICES_SECONDS * FS
    rng = np.random.default_rng(95)
    t = np.arange(n)[:, None] / FS
    xs = np.stack([0.2 * rng.standard_normal((n, CHANNELS))
                   + 0.3 * np.sin(2 * np.pi * np.array([40.0, 1000.0]) * (1 + 0.1 * s) * t)
                   for s in range(S)])
    print(f"process_batch across devices {list(DEVICES)}: {S} streams of {DEVICES_SECONDS} s, "
          f"{S // len(DEVICES)} a group, against one group of {S}")
    for label, words, B, dt in DEVICES_CASES:
        np.random.seed(SLICE_C_SEED)
        chain = build_chain_from_string(words or MC_CHAIN, StreamInfo(FS, CHANNELS))
        cc = CompiledChain(chain, B, dtype=getattr(torch, dt), device="cuda")
        what = f"{label} -b {B} {dt}"
        warm = xs[:, :2 * cc.block_frames]
        _require(f"devices {what}: the warming batch differs",
                 np.array_equal(cc.process_batch(warm), cc.process_batch(warm, devices=DEVICES)))
        walls, kernels, first = {1: [], 2: []}, {1: [], 2: []}, None
        for groups in (1, 2, 2, 1):
            torch.cuda.synchronize()
            k0, t0 = kernel_total(), time.perf_counter()
            y = cc.process_batch(xs, devices=DEVICES if groups == 2 else None)
            walls[groups].append(time.perf_counter() - t0)
            kernels[groups].append(kernel_total() - k0)
            if first is None:
                first = y
                _require(f"devices {what}: output {y.shape}, not finite or empty",
                         y.shape[0] == S and y.shape[1] > 0 and np.isfinite(y).all())
            _require(f"devices {what}: {groups} group(s) differ from one group",
                     np.array_equal(y, first))
        k1, k2 = kernels[1][0], kernels[2][0]
        _require(f"devices {what}: kernels {kernels}: two groups must launch twice one group's",
                 k1 > 0 and set(kernels[1]) == {k1} and set(kernels[2]) == {2 * k1})
        w1, w2 = float(np.mean(walls[1])), float(np.mean(walls[2]))
        secs = S * DEVICES_SECONDS
        print(f"  {what} (block {cc.block_frames}): one group {walls[1][0]:.3f}, "
              f"{walls[1][1]:.3f} s ({secs / w1:.1f} s of audio a second); two groups "
              f"{walls[2][0]:.3f}, {walls[2][1]:.3f} s ({secs / w2:.1f}); two / one "
              f"{w2 / w1:.3f}; kernels {k1} and {k2}; bit-equal")
        if B == 2048 and dt == "float64":
            mixed_devices_check(what, words or MC_CHAIN, B, xs[:, :MIXED_FRAMES])
    shape = dryrun_multidevice(list(DEVICES))
    _require(f"dryrun_multidevice: output {shape}", shape[0] == 4)


# the port's sgen as the CLI's input: 10 s of two sines
SGEN_INPUT = "sine@0:freq=1k/sine@1:freq=3k+10"


def sgen_cli_phase(records, tmp):
    """The flagship through dsp-torch on the card from the port's sgen codec
    (SGEN_INPUT), held to the same command on the CPU within LIMIT_DBFS;
    its K1 and crossfeed launches counted (zeroed just before the card's
    run, read just after) and required."""
    import contextlib
    import io
    import os

    import numpy as np

    from dsp_tpu_torch.cli.main import main as cli_main
    from dsp_tpu_torch.ops import iir

    wrappers = {"lti_blocked": iir.lti_blocked, "crossfeed_step": iir.crossfeed_step}
    outs = {}
    for device in ("cuda", "cpu"):
        out = tmp / f"sgen_{device}.wav"
        os.environ["DSP_TPU_TORCH_DEVICE"] = device
        for w in wrappers.values():
            w.launches = 0
        err = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(err):
                rc = cli_main(["-q", "-t", "sgen", "-c", str(CHANNELS), SGEN_INPUT, "-o", "-e",
                               "double", str(out), *FLAGSHIP.split()])
        finally:
            os.environ["DSP_TPU_TORCH_DEVICE"] = "cuda"
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SmokeError(f"sgen on {device}: dsp-torch exited {rc}: {err.getvalue()[-2000:]}")
        counts = {name: w.launches for name, w in wrappers.items()}
        if device == "cuda":
            _require(f"sgen on the card: kernels not launched: {counts}", min(counts.values()) > 0)
            for name, c in counts.items():
                records[name]["launches"] += c
        total, outs[device] = read_wav(out)
        out.unlink()
        print(f"  sgen -> flagship on {device}: {wall:.3f} s wall, {total} frames, launches {counts}")
    y, ref = outs["cuda"], outs["cpu"]
    _require(f"sgen: {y.shape} frames on the card, {ref.shape} on the CPU",
             y.shape == ref.shape == (10 * FS, CHANNELS) and np.isfinite(y).all()
             and np.abs(ref).max() > 0.1)
    diff = float(np.abs(y - ref).max())
    print(f"  sgen -> flagship: card vs CPU max |diff| {diff:.3e} ({dbfs(diff):.1f} dBFS, "
          f"limit {LIMIT_DBFS})")
    _require(f"sgen: card vs CPU {dbfs(diff):.1f} dBFS", dbfs(diff) <= LIMIT_DBFS)


def plot_phase():
    """dsp-torch -p and -P of the flagship (two channels): exit 0 and the
    gnuplot program on stdout, each channel's magnitude plotted (and with
    -P its phase), ending in `pause mouse close`."""
    import contextlib
    import io

    from dsp_tpu_torch.cli.main import main as cli_main

    for flag in ("-p", "-P"):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main([flag, "-c", str(CHANNELS), "-n", *FLAGSHIP.split()])
        text = out.getvalue()
        _require(f"dsp-torch {flag}: exit {rc}: {err.getvalue()[-2000:]}", rc == 0)
        need = ["Ht0_mag_dB(x)", "Ht1_mag_dB(x)"] + (
            ["Ht0_phase_deg(x) axes x1y2", "set y2range"] if flag == "-P" else [])
        _require(f"dsp-torch {flag}: not the gnuplot program: {text[:400]!r}",
                 text.startswith("set xlabel 'Frequency (Hz)'")
                 and text.endswith("pause mouse close\n") and all(k in text for k in need))
        print(f"  dsp-torch {flag} (flagship): {len(text.splitlines())} lines of gnuplot, "
              f"{len(text)} bytes")


def _counting_steps():
    """Patch CompiledChain._step to count the chain's host steps; returns
    (the counter, a function that restores the step)."""
    from dsp_tpu_torch.chain import chain as chain_mod

    real = chain_mod.CompiledChain._step
    steps = [0]

    def counted(self, states, x):
        steps[0] += 1
        return real(self, states, x)

    chain_mod.CompiledChain._step = counted

    def restore():
        chain_mod.CompiledChain._step = real
    return steps, restore


def split_phase(records, tmp, kept, n_in, seconds):
    """Slice H1 file to file and in batches, on the card. On the main path's
    input (tmp/in.wav, `seconds` s), for the flagship (float64 and float32),
    `fir` 64k at -b 2048 and `lowpass 18k 0.7071 resample 96k`: dsp-torch
    with DSP_TPU_SPLIT=SPLIT_SEGMENTS, timed (× realtime) beside the
    sequential render (the main path's, kept, and its wall; rendered here
    for the resampler); in the process, without the codecs, process_array
    and process_array_split on the same input, timed, with their kernels a
    host step from the libraries' counts (kernel_total), which must be
    equal at S = 1 and S = 8 (and in the split render); the look-back in
    frames and blocks. The float64 split against the sequential render:
    segment 0 bit-equal, the whole within SPLIT_DBFS; the float32 split
    against the float64 sequential render within F32_LIMIT_DBFS. Then
    process_batch on BATCH_STREAMS streams of
    BATCH_SECONDS s: the flagship and `fir` 64k (float64), each stream
    within BATCH_ABS of a sequential process_array on the card, and the
    chains that take the other stream-axis forms (the flagship at -b 1000,
    a lone per-sample biquad and a Thiran delay, `fir_p` 1M's Nupols
    stage, the float32 FFT convolution and resampler, `resample 44101`'s
    route of three launches), float32 within one ulp of the scale. Every
    stream-axis form's row counts the launches of the split renders and the
    batches, and must have run."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_args
    from dsp_tpu_torch.chain.chain import expected_out_frames
    from dsp_tpu_torch.cli.main import main as cli_main
    from dsp_tpu_torch.core.types import StreamInfo

    src = tmp / "in.wav"
    f64k, f1m = tmp / "f64k.wav", tmp / "f1m.wav"
    wrappers = _stream_wrappers()
    for rec, w in wrappers.items():
        records[rec]["launches"] = 0

    def stream_counts_zero():
        for w in wrappers.values():
            w.launches = 0

    def stream_counts_add():
        for rec, w in wrappers.items():
            records[rec]["launches"] += w.launches

    def render(label, words, block, dtype, split):
        """One dsp-torch run of `words` on in.wav: (output frames and
        samples, wall s, kernels, host steps)."""
        out = tmp / "split_out.wav"
        argv = (["-b", str(block)] if block != 2048 else []) + [
            "-q", str(src), "-o", "-e", "double", str(out), *words]
        env = {"DSP_TPU_TORCH_DTYPE": dtype}
        if split:
            env["DSP_TPU_SPLIT"] = str(SPLIT_SEGMENTS)
        os.environ.update(env)
        steps, restore = _counting_steps()
        err = io.StringIO()
        try:
            if split:
                stream_counts_zero()
            torch.cuda.synchronize()
            k0 = kernel_total()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = cli_main(argv)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            kern = kernel_total() - k0
            if split:
                stream_counts_add()
        finally:
            restore()
            for k in env:
                os.environ.pop(k)
        if rc != 0:
            raise SmokeError(f"{label}: dsp-torch exited {rc}: {err.getvalue()[-2000:]}")
        got = read_wav(out)
        out.unlink()
        return got, wall, kern, steps[0]

    # (label, words, the main path's kept float64 render and its cli_run
    # label, or None: rendered here sequentially)
    runs = (("flagship", FLAGSHIP.split(), (FLAGSHIP, 2048), "flagship -b 2048"),
            ("fir 64k -b 2048", ["fir", str(f64k)], ("fir 64k", 2048),
             "fir 64k -b 2048 (Upols, K = 32)"),
            ("lowpass 18k 0.7071 resample 96k", "lowpass 18k 0.7071 resample 96k".split(), None,
             None))
    _, x = read_wav(src)
    print(f"split renders: {seconds} s of stereo {FS} Hz, DSP_TPU_SPLIT={SPLIT_SEGMENTS}")
    for label, words, key, main_label in runs:
        chain = build_chain_from_args(words, StreamInfo(FS, CHANNELS))
        cc = CompiledChain(chain, 2048, device="cuda")
        B, lookback = cc.block_frames, cc.split_lookback_frames()
        b_out = int(B * chain.ratio)
        out_valid = expected_out_frames(chain, n_in)
        nb = max(1, -(-(n_in + chain.drain_frames) // B), -(-out_valid // b_out))
        wb, seg_nb = -(-lookback // B), -(-nb // SPLIT_SEGMENTS)
        seg0 = seg_nb * b_out - chain.output_discard
        if key is None:
            (_, y_seq), w_seq, _, _ = render(label, words, 2048, "float64", False)
        else:
            _, y_seq = read_wav(kept[key])
            w_seq = WALLS[main_label]
        for dtype in ("float64", "float32") if label == "flagship" else ("float64",):
            # the two routes in the process, without the codecs: their
            # kernels a host step by the libraries' counts, and the chain's
            # share of a render's wall time
            cc = CompiledChain(chain, 2048, dtype=getattr(torch, dtype), device="cuda")
            per, walls = [], []
            for fn in (lambda: cc.process_array(x),
                       lambda: cc.process_array_split(x, splits=SPLIT_SEGMENTS)):
                steps, restore = _counting_steps()
                try:
                    torch.cuda.synchronize()
                    k0, t0 = kernel_total(), time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    per.append((kernel_total() - k0) / steps[0])
                finally:
                    restore()
            _require(f"{label} {dtype}: {per[1]:.3f} kernels a step at S={SPLIT_SEGMENTS}, "
                     f"{per[0]:.3f} at S=1", per[1] == per[0])
            (n_sp, y_sp), w_sp, k_sp, st_sp = render(label, words, 2048, dtype, True)
            _require(f"{label} {dtype}: {n_sp} split frames, {len(y_seq)} sequential",
                     n_sp == len(y_seq) and len(y_sp) == len(y_seq))
            _require(f"{label} {dtype}: {st_sp} split steps, expected {wb + seg_nb} (the "
                     f"split route did not run)", st_sp == wb + seg_nb)
            _require(f"{label} {dtype}: {k_sp / st_sp:.3f} kernels a step in the split render, "
                     f"{per[0]:.3f} at S=1", k_sp / st_sp == per[0])
            print(f"  {label} {dtype}: dsp-torch"
                  + (f" sequential {w_seq:.3f} s wall, {seconds / w_seq:.1f}x realtime"
                     + ("" if key is None else " (the main path's render)") + ";"
                     if dtype == "float64" else "")
                  + f" split {w_sp:.3f} s wall, {seconds / w_sp:.1f}x realtime, {st_sp} steps "
                  f"of S={-(-nb // seg_nb)}; in the process (no codec): process_array "
                  f"{walls[0]:.3f} s ({seconds / walls[0]:.1f}x), process_array_split "
                  f"{walls[1]:.3f} s ({seconds / walls[1]:.1f}x); kernels a step {per[0]:.3f} at "
                  f"S=1, {per[1]:.3f} at S={SPLIT_SEGMENTS}; look-back {lookback} frames, {wb} "
                  f"blocks of {B}; segments of {seg_nb} blocks")
            if not np.isfinite(y_sp).all():
                raise SmokeError(f"{label} {dtype}: non-finite split output")
            if dtype == "float64":
                _require(f"{label}: segment 0 ({seg0} frames) differs from the sequential "
                         f"render", np.array_equal(y_sp[:seg0], y_seq[:seg0]))
                diff = float(np.abs(y_sp - y_seq).max())
                print(f"  {label}: split against sequential: segment 0 bit-equal, max |diff| "
                      f"{diff:.3e} ({dbfs(diff):.1f} dBFS, limit {SPLIT_DBFS})")
                _require(f"{label}: split {dbfs(diff):.1f} dBFS from sequential",
                         dbfs(diff) <= SPLIT_DBFS)
            else:
                diff = float(np.abs(y_sp - y_seq).max())
                print(f"  {label} float32 split against the float64 sequential render: max "
                      f"|diff| {diff:.3e} ({dbfs(diff):.1f} dBFS, limit {F32_LIMIT_DBFS})")
                _require(f"{label}: float32 split {dbfs(diff):.1f} dBFS from float64",
                         dbfs(diff) <= F32_LIMIT_DBFS)
        del y_seq, y_sp
    del x

    rng = np.random.default_rng(20319)
    batches = (("flagship", FLAGSHIP.split(), 2048, torch.float64),
               ("fir 64k", ["fir", str(f64k)], 2048, torch.float64),
               ("flagship -b 1000 (the run)", FLAGSHIP.split(), 1000, torch.float64),
               ("flagship -b 1000 (the run)", FLAGSHIP.split(), 1000, torch.float32),
               ("highpass 30 0.7071 delay -f 0.37m -b 1000", "highpass 30 0.7071 delay -f 0.37m".split(),
                1000, torch.float64),
               ("highpass 30 0.7071 delay -f 0.37m -b 1000", "highpass 30 0.7071 delay -f 0.37m".split(),
                1000, torch.float32),
               ("fir_p 1M (Nupols)", ["fir_p", str(f1m)], 2048, torch.float64),
               ("fir_p 1M (Nupols)", ["fir_p", str(f1m)], 2048, torch.float32),
               ("resample 48k", ["resample", "48k"], 2048, torch.float32),
               ("resample 44101", ["resample", "44101"], 2048, torch.float64),
               ("resample 44101", ["resample", "44101"], 2048, torch.float32))
    print(f"process_batch: {BATCH_STREAMS} streams of {BATCH_SECONDS} s")
    for label, words, block, dt in batches:
        cc = CompiledChain(build_chain_from_args(words, StreamInfo(FS, CHANNELS)), block, dtype=dt,
                           device="cuda")
        secs = 2 if "44101" in label else BATCH_SECONDS
        xs = rng.standard_normal((BATCH_STREAMS, secs * FS, CHANNELS)) * 0.1
        stream_counts_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yb = cc.process_batch(xs)
        wall = time.perf_counter() - t0
        stream_counts_add()
        worst = 0.0
        for s in range(BATCH_STREAMS):
            cc.reset()
            one = cc.process_array(xs[s])
            if dt == torch.float64:
                e = float(np.abs(yb[s] - one).max())
                _require(f"process_batch {label}: stream {s} {e:.3e} from process_array",
                         e <= BATCH_ABS)
            else:
                ulps, e = _ulps(torch.as_tensor(yb[s]), torch.as_tensor(one))
                _require(f"process_batch {label} float32: stream {s} {ulps:.2f} ulp of the scale "
                         f"from process_array", ulps <= 1.0)
            worst = max(worst, e)
        print(f"  {label} {str(dt)[6:]}: {wall:.3f} s for the batch; each stream against "
              f"process_array on the card: max |diff| {worst:.3e}")
    idle = [rec for rec in wrappers if records[rec]["launches"] == 0]
    _require(f"stream-axis forms never launched in the split renders and batches: {idle}",
             not idle)
    print("stream-axis launches in the split renders and batches: "
          + ", ".join(f"{rec} {records[rec]['launches']}" for rec in wrappers))


def nupols_no_sync(f1m):
    """The Nupols step does not synchronise: CompiledChain.run_blocks over
    3 super-blocks (96 blocks at B = 2048) of input already on the card,
    under torch.cuda.set_sync_debug_mode("error")."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_args
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops.fft_conv import NupolsConv

    cc = CompiledChain(build_chain_from_args(["fir_p", str(f1m)], StreamInfo(FS, CHANNELS)),
                       2048, device="cuda")
    eng = cc._runtime_effects[0]._engine(2048)
    if not isinstance(eng, NupolsConv) or (eng.m, eng.K1, eng.head.K) != (32, 15, 32):
        raise SmokeError(f"fir_p 1M at B=2048: engine {type(eng).__name__}, expected Nupols m=32")
    rng = np.random.default_rng(11)
    warm = torch.as_tensor(rng.standard_normal((40, 2048, CHANNELS)) * 0.1, device="cuda")
    xs = torch.as_tensor(rng.standard_normal((96, 2048, CHANNELS)) * 0.1, device="cuda")
    cc.run_blocks(warm)  # uploads the spectra, plans the FFTs, fires once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = cc.run_blocks(xs)
    except RuntimeError as e:
        raise SmokeError(f"the Nupols step synchronised: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not torch.isfinite(ys).all():
        raise SmokeError("the Nupols run without syncs gave non-finite output")
    print(f"Nupols step: 96 blocks (3 super-blocks of 32) ran with no host sync, "
          f"cnt = {int(cc.states[0]['cnt'])}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import dsp_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: dsp_tpu_torch not found beside this script: {e}", file=sys.stderr)
        return 1
    if Path(dsp_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print(f"chip_smoke: dsp_tpu_torch imported from {dsp_tpu_torch.__file__}, "
              f"not from beside this script", file=sys.stderr)
        return 1

    # library_ms stays null where no one PyTorch call computes the function
    records = {
        name: {"name": name, "route": "cuda", "source": f"dsp_tpu_torch/csrc/{src}.cu",
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
               "library_ms": None, "timed_at": timed_at}
        for name, src, replaces, timed_at in (
            ("lti_blocked", "lti_blocked", "dsp_tpu/ops/iir.py:566", "B=2048"),
            ("biquad_scan", "biquad_scan", "dsp_tpu/ops/iir.py:77", "B=2048"),
            ("crossfeed_step", "biquad_scan",
             "dsp_tpu/effects/crossfeed.py:40-55 (K2, dsp_tpu/ops/iir.py:77, and the mix)",
             "B=2048, C=2"),
            ("crossfeed_step_f32", "biquad_scan",
             "dsp_tpu/effects/crossfeed.py:40-55 in float32 (K2 and the mix)",
             "float32, B=2048, C=2"),
            ("biquad_scan_series", "biquad_scan",
             "dsp_tpu/effects/matrix4.py:431-432 (K2 twice, dsp_tpu/ops/iir.py:77)",
             "matrix4's band-limit, B=2048, C=2"),
            ("biquad_scan_pair", "biquad_scan",
             "dsp_tpu/effects/biquad.py:329 (K2 on hi + lo, dsp_tpu/ops/iir.py:77)",
             "highpass 30, B=1000, C=2"),
            ("biquad_scan_run", "biquad_scan",
             "dsp_tpu/effects/biquad.py:329 (K2 a biquad, dsp_tpu/ops/iir.py:77) for a run of "
             "biquads; dsp_tpu/effects/matrix4_mb.py:338-349,616-622 (biquad_scan_auto twice)",
             "the flagship's six biquads, B=1000, C=2, (hi, lo) states"),
            ("biquad_scan_run_df", "biquad_scan",
             "dsp_tpu/ops/iir.py:89 (biquad_scan_df, effects/biquad.py:329 in float32) for a run "
             "of biquads; dsp_tpu/ops/iir.py:129 (biquad_scan_auto, matrix4_mb's fshape)",
             "float32, the flagship's six biquads, B=1000, C=2, (hi, lo) states"),
            ("rfft_pack", "fft_conv", "dsp_tpu/ops/fft_conv.py:85,137,204", "N=4096, C=2"),
            ("fdl_mac", "fdl_mac", "dsp_tpu/ops/fft_conv.py:85,137,204", "K=32, NB=2049, C=2"),
            ("irfft_crop", "fft_conv", "dsp_tpu/ops/fft_conv.py:85,137,204", "N=4096, C=2"),
            ("splice", "fft_conv", "dsp_tpu/ops/fft_conv.py:85,137,204", "L=2048, C=2"),
            ("mod_delay", "mod_delay", "dsp_tpu/effects/delay.py:292,337", "q2 -M, B=2048, C=2"),
            ("tpdf_dither", "tpdf", "dsp_tpu/effects/dither.py:107", "lipshitz, B=2048, C=2"),
            ("tpdf_noise", "tpdf", "dsp_tpu/effects/noise.py:51", "B=2048, C=2"),
            ("stats_step", "stats", "dsp_tpu/effects/stats.py:159,197,266", "-i, B=2048, C=2"),
            ("stats_step_plain", "stats", "dsp_tpu/effects/stats.py:159,266 (plain mode)",
             "plain, B=2048, C=2"),
            ("levels_step", "levels", "dsp_tpu/effects/levels.py:62", "B=2048, C=2"),
            ("resample_step", "resample", "dsp_tpu/ops/resample_ops.py:144",
             "48 kHz, 4 x 588 frames, C=2 (one launch)"),
            ("resample_fold", "resample", "dsp_tpu/ops/resample_ops.py:144",
             "48 kHz, 4 x 588 frames, C=2 (the route of three launches)"),
            ("irfft_ola", "fft_conv",
             "dsp_tpu/ops/resample_ops.py:144 (its irfft, scale and overlap-add)",
             "resample 44101: N=88202, C=2 (the route of three launches)"),
            ("m4_env", "m4_env", "dsp_tpu/ops/m4_engine.py:267", "B=2048"),
            ("m4_event", "m4_event", "dsp_tpu/ops/m4_engine.py:395,730,784,887",
             "Nc=64, v4, S=1"),
            ("m4_audio", "m4_audio", "dsp_tpu/effects/matrix4.py:597,673,699", "B=2048, v4"),
            ("lti_blocked@bank", "lti_blocked", "dsp_tpu/ops/iir.py:566",
             "matrix4_mb's 13-band bank: C=26, n=40, L=128, B=2048"),
            ("m4mb_env", "m4_env", "dsp_tpu/ops/m4_engine.py:267 (effects/matrix4_mb.py:397-432)",
             "B=2048, S=13"),
            ("m4mb_event", "m4_event",
             "dsp_tpu/ops/m4_engine.py:395 (effects/matrix4_mb.py:445-551)", "Nc=64, v4, 13 bands"),
            ("m4mb_audio", "m4mb_audio", "dsp_tpu/effects/matrix4_mb.py:569,778", "B=2048, v4"),
            ("lti_blocked_f32", "lti_blocked", "dsp_tpu/ops/iir.py:574-631 (lti_blocked_df :556)",
             "float32, flagship cascade: C=2, n=12, L=128, B=2048"),
            ("biquad_scan_df", "biquad_scan", "dsp_tpu/ops/iir.py:89 (biquad_scan_auto :129)",
             "float32, highpass 30: C=2, B=1000"),
            ("biquad_scan_f32", "biquad_scan",
             "dsp_tpu/ops/iir.py:77 in float32 (effects/crossfeed.py:48, effects/delay.py:172)",
             "float32, crossfeed: C=4, B=2048"),
            ("rfft_pack_f32", "fft_conv",
             "dsp_tpu/ops/resample_ops.py:191 (dfx_fft.py:30,123: the forward DfDft); "
             "dsp_tpu/ops/fft_conv.py:97,144,220 (complex64)",
             "float32, 48 kHz: N=1176, 8 columns"),
            ("resample_step_f32", "resample",
             "dsp_tpu/ops/resample_ops.py:191 (_block_df; dfx_fft.py:30,123)",
             "float32, 48 kHz, 4 x 588 frames, C=2 (one launch)"),
            ("irfft_ola_f32", "fft_conv",
             "dsp_tpu/ops/resample_ops.py:191-233 (dfx_fft.py:30,123: the inverse DfDft)",
             "float32, 48 kHz: N=1280, 8 columns"),
            ("fdl_mac_f32", "fdl_mac", "dsp_tpu/ops/fft_conv.py:97,144,220 (complex64)",
             "float32 FDL, K=32, NB=2049, C=2"),
            ("irfft_crop_f32", "fft_conv", "dsp_tpu/ops/fft_conv.py:97,144,220 (complex64)",
             "float32, N=4096, C=2, with the addend"),
            ("splice_f32", "fft_conv", "dsp_tpu/ops/fft_conv.py:97,144,220",
             "float32, L=2048, C=2"),
            ("m4_env_f32", "m4_env", "dsp_tpu/ops/m4_engine.py:267 (df=True)", "float32, B=2048"),
            ("m4_event_f32", "m4_event",
             "dsp_tpu/ops/m4_engine.py:395 over dfx.DF, :225 (dfx.py:113-520)",
             "float32, Nc=64, v4, S=1"),
            ("m4_audio_f32", "m4_audio", "dsp_tpu/effects/matrix4.py:597,673,699 in float32",
             "float32, B=2048, v4"),
            ("m4mb_env_f32", "m4_env",
             "dsp_tpu/ops/m4_engine.py:267 (df=True; effects/matrix4_mb.py:397-432)",
             "float32, B=2048, S=13"),
            ("m4mb_event_f32", "m4_event",
             "dsp_tpu/ops/m4_engine.py:395 over dfx.DF (effects/matrix4_mb.py:445-551)",
             "float32, Nc=64, v4, 13 bands"),
            ("m4mb_audio_f32", "m4mb_audio", "dsp_tpu/effects/matrix4_mb.py:569,778 in float32",
             "float32, B=2048, v4"),
            ("mod_delay_f32", "mod_delay", "dsp_tpu/effects/delay.py:292,337 in float32",
             "float32, q2 -M, B=2048, C=2"),
            ("tpdf_dither_f32", "tpdf", "dsp_tpu/effects/dither.py:107 in float32",
             "float32, lipshitz, B=2048, C=2"),
            ("tpdf_noise_f32", "tpdf", "dsp_tpu/effects/noise.py:51 in float32",
             "float32, B=2048, C=2"),
            ("stats_step_plain_f32", "stats",
             "dsp_tpu/effects/stats.py:159,266 (plain mode) in float32", "float32, plain, B=2048, C=2"),
            ("stats_step_f32", "stats", "dsp_tpu/effects/stats.py:159,197,266 in float32",
             "float32, -i, B=2048, C=2"),
            ("levels_step_f32", "levels", "dsp_tpu/effects/levels.py:62 in float32",
             "float32, B=2048, C=2"),
        ) + tuple(
            # slice H1's stream-axis forms: S streams in one launch, where
            # dsp_tpu vmaps the chain's step over its stream axis
            # (dsp_tpu/chain/chain.py:778 process_batch, :880
            # process_array_split)
            (rec, src, f"{replaces}, vmapped over streams (dsp_tpu/chain/chain.py:778,880)",
             f"S={TIMED_STREAMS} streams (ms_s1, device_ms_s1: one stream), {at}")
            for rec, src, replaces, at in (
                ("lti_blocked@S", "lti_blocked", "dsp_tpu/ops/iir.py:566",
                 "flagship cascade, B=2048, C=2"),
                ("lti_blocked_f32@S", "lti_blocked", "dsp_tpu/ops/iir.py:574-631",
                 "float32, flagship cascade, B=2048, C=2"),
                ("crossfeed_step@S", "biquad_scan", "dsp_tpu/effects/crossfeed.py:40-55",
                 "B=2048, C=2"),
                ("crossfeed_step_f32@S", "biquad_scan",
                 "dsp_tpu/effects/crossfeed.py:40-55 in float32", "float32, B=2048, C=2"),
                ("biquad_scan_run@S", "biquad_scan", "dsp_tpu/effects/biquad.py:329 for a run",
                 "six biquads, B=1000, C=2, (hi, lo) states"),
                ("biquad_scan_run_df@S", "biquad_scan", "dsp_tpu/ops/iir.py:89 for a run",
                 "float32, six biquads, B=1000, C=2, (hi, lo) states"),
                ("biquad_scan@S", "biquad_scan", "dsp_tpu/ops/iir.py:77 (effects/delay.py:172)",
                 "highpass 30, B=2048, C=2"),
                ("biquad_scan_f32@S", "biquad_scan", "dsp_tpu/ops/iir.py:77 in float32",
                 "float32, highpass 30, B=2048, C=2"),
                ("biquad_scan_pair@S", "biquad_scan", "dsp_tpu/effects/biquad.py:329",
                 "highpass 30, B=1000, C=2, (hi, lo) state"),
                ("biquad_scan_df@S", "biquad_scan", "dsp_tpu/ops/iir.py:89",
                 "float32, highpass 30, B=1000, C=2, (hi, lo) state"),
                ("rfft_pack@S", "fft_conv", "dsp_tpu/ops/fft_conv.py:85,137,204",
                 "N=4096, C=2, 2048 rows kept"),
                ("rfft_pack_f32@S", "fft_conv", "dsp_tpu/ops/fft_conv.py:97,144,220",
                 "float32, N=4096, C=2, 2048 rows kept"),
                ("fdl_mac@S", "fdl_mac", "dsp_tpu/ops/fft_conv.py:85,137,204",
                 "K=32, NB=2049, C=2"),
                ("fdl_mac_f32@S", "fdl_mac", "dsp_tpu/ops/fft_conv.py:97,144,220",
                 "float32 FDL, K=32, NB=2049, C=2"),
                ("irfft_crop@S", "fft_conv", "dsp_tpu/ops/fft_conv.py:85,137,204",
                 "N=4096, C=2, with the addend"),
                ("irfft_crop_f32@S", "fft_conv", "dsp_tpu/ops/fft_conv.py:97,144,220",
                 "float32, N=4096, C=2, with the addend"),
                ("splice@S", "fft_conv", "dsp_tpu/ops/fft_conv.py:204 (the stage)",
                 "L=65536, C=2"),
                ("splice_f32@S", "fft_conv", "dsp_tpu/ops/fft_conv.py:220 (the stage)",
                 "float32, L=65536, C=2"),
                ("resample_step@S", "resample", "dsp_tpu/ops/resample_ops.py:144",
                 "48 kHz, 4 x 588 frames, C=2"),
                ("resample_step_f32@S", "resample", "dsp_tpu/ops/resample_ops.py:191",
                 "float32, 48 kHz, 4 x 588 frames, C=2"),
                ("irfft_ola@S", "fft_conv", "dsp_tpu/ops/resample_ops.py:144 (its irfft and "
                 "overlap-add)", "resample 44101: N=88202, C=2, an inner block a stream"),
                ("irfft_ola_f32@S", "fft_conv", "dsp_tpu/ops/resample_ops.py:191-233",
                 "float32, resample 44101: N=88202, C=2, an inner block a stream"),
            )) + tuple(
            # slice H2a's: the upmixes' kernels, S streams in one launch,
            # where dsp_tpu vmaps the step of process_batch
            (rec, src, f"{replaces}, vmapped over streams (dsp_tpu/chain/chain.py:778)",
             f"S={TIMED_STREAMS} streams (ms_s1, device_ms_s1: one stream), {at}")
            for rec, src, replaces, at in (
                ("biquad_scan_series@S", "biquad_scan", "dsp_tpu/effects/matrix4.py:431-432",
                 "matrix4's band-limit, B=2048, C=2"),
                ("m4_env@S", "m4_env", "dsp_tpu/ops/m4_engine.py:267", "B=2048, a lane a stream"),
                ("m4_env_f32@S", "m4_env", "dsp_tpu/ops/m4_engine.py:267 (df=True)",
                 "float32, B=2048, a lane a stream"),
                ("m4mb_env@S", "m4_env",
                 "dsp_tpu/ops/m4_engine.py:267 (effects/matrix4_mb.py:397-432)",
                 "B=2048, 13 lanes a stream"),
                ("m4mb_env_f32@S", "m4_env",
                 "dsp_tpu/ops/m4_engine.py:267 (df=True; effects/matrix4_mb.py:397-432)",
                 "float32, B=2048, 13 lanes a stream"),
                ("m4_event@S", "m4_event", "dsp_tpu/ops/m4_engine.py:395,730,784,887",
                 "Nc=64, v4, a lane a stream"),
                ("m4_event_f32@S", "m4_event", "dsp_tpu/ops/m4_engine.py:395 over dfx.DF",
                 "float32, Nc=64, v4, a lane a stream"),
                ("m4mb_event@S", "m4_event",
                 "dsp_tpu/ops/m4_engine.py:395 (effects/matrix4_mb.py:445-551)",
                 "Nc=64, v4, 13 bands a stream, a block a stream"),
                ("m4mb_event_f32@S", "m4_event",
                 "dsp_tpu/ops/m4_engine.py:395 over dfx.DF (effects/matrix4_mb.py:445-551)",
                 "float32, Nc=64, v4, 13 bands, a block a stream"),
                ("m4_audio@S", "m4_audio", "dsp_tpu/effects/matrix4.py:597,673,699",
                 "B=2048, v4, a block a stream"),
                ("m4_audio_f32@S", "m4_audio", "dsp_tpu/effects/matrix4.py:597,673,699 in float32",
                 "float32, B=2048, v4, a block a stream"),
                ("m4mb_audio@S", "m4mb_audio", "dsp_tpu/effects/matrix4_mb.py:569,778",
                 "B=2048, v4, tiles of 256 of each stream"),
                ("m4mb_audio_f32@S", "m4mb_audio",
                 "dsp_tpu/effects/matrix4_mb.py:569,778 in float32",
                 "float32, B=2048, v4, tiles of 256 of each stream"),
            )) + tuple(
            # slice H2b's: the time-domain effects' kernels, S streams in one
            # launch, where dsp_tpu vmaps the step of process_batch
            (rec, src, f"{replaces}, vmapped over streams (dsp_tpu/chain/chain.py:778)",
             f"S={TIMED_STREAMS} streams (ms_s1, device_ms_s1: one stream), {at}")
            for rec, src, replaces, at in (
                ("tpdf_noise@S", "tpdf", "dsp_tpu/effects/noise.py:51", "B=2048, C=2"),
                ("tpdf_noise_f32@S", "tpdf", "dsp_tpu/effects/noise.py:51 in float32",
                 "float32, B=2048, C=2"),
                ("tpdf_dither@S", "tpdf", "dsp_tpu/effects/dither.py:107",
                 "lipshitz, B=2048, C=2, a block a channel group of each stream"),
                ("tpdf_dither_f32@S", "tpdf", "dsp_tpu/effects/dither.py:107 in float32",
                 "float32, lipshitz, B=2048, C=2, a block a channel group of each stream"),
                ("stats_step@S", "stats", "dsp_tpu/effects/stats.py:159,197,266",
                 "-i, B=2048, C=2, a block a channel of each stream"),
                ("stats_step_f32@S", "stats", "dsp_tpu/effects/stats.py:159,197,266 in float32",
                 "float32, -i, B=2048, C=2, a block a channel of each stream"),
                ("stats_step_plain@S", "stats", "dsp_tpu/effects/stats.py:159,266 (plain mode)",
                 "plain, B=2048, C=2, tiles of each stream"),
                ("stats_step_plain_f32@S", "stats",
                 "dsp_tpu/effects/stats.py:159,266 (plain mode) in float32",
                 "float32, plain, B=2048, C=2, tiles of each stream"),
                ("levels_step@S", "levels", "dsp_tpu/effects/levels.py:62",
                 "B=2048, C=2, tiles of each stream"),
                ("levels_step_f32@S", "levels", "dsp_tpu/effects/levels.py:62 in float32",
                 "float32, B=2048, C=2, tiles of each stream"),
                ("mod_delay@S", "mod_delay", "dsp_tpu/effects/delay.py:292,337",
                 "q2 -M, 1 kHz, B=2048, C=2, tiles of each stream"),
                ("mod_delay_f32@S", "mod_delay", "dsp_tpu/effects/delay.py:292,337 in float32",
                 "float32, q2 -M, 1 kHz, B=2048, C=2, tiles of each stream"),
            ))
    }
    tmp = ROOT / ".smoke_tmp" / "run"  # removed at the end; scratch scripts may sit beside it
    f32refs = None
    try:
        print(card_info())
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()

        def timed(fn, *args):  # a phase, with its wall seconds printed
            t = time.perf_counter()
            out = fn(*args)
            print(f"[{fn.__name__}: {time.perf_counter() - t:.1f} s, "
                  f"{time.perf_counter() - t0:.1f} s in all]")
            return out

        timed(build_kernels)
        timed(kernel_phases, records)
        timed(k2_fused_phase, records)
        timed(biquad_run_phase, records)
        timed(lean_wrapper_refusals)
        timed(fdl_mac_phase, records)
        timed(step_kernels_phase, records)
        timed(time_domain_phase, records)
        timed(float32_time_domain_phase, records)
        timed(resample_phase, records)
        timed(split_kernel_phase, records)
        timed(matrix4_phase, records)
        timed(matrix4_mb_phase, records)
        timed(lookback_phase)
        timed(bench_golden_check)
        timed(mb_golden_check)
        tmp.mkdir(parents=True, exist_ok=True)
        f1m, f4k, kept = timed(main_path, records, SECONDS, tmp)
        f32refs = float32_time_domain_refs(tmp)
        timed(split_phase, records, tmp, kept, SECONDS * FS, SECONDS)
        timed(batch_upmix_phase, records)
        timed(batch_td_phase, records)
        timed(devices_phase)
        timed(sgen_cli_phase, records, tmp)
        timed(plot_phase)
        timed(float32_phase, records, tmp, kept)
        engine_tick_line(records)
        timed(float32_time_domain_cli, records, tmp, f32refs)
        left = f32refs.close()
        _require(f"float32_time_domain_cli: {left} CPU runs were computed for no run", not left)
        timed(nupols_no_sync, f1m)
        timed(delivery_no_sync)
        timed(matrix4_no_sync)
        timed(matrix4_mb_no_sync)
        timed(float32_no_sync)
        timed(profile_chains, f4k, tmp / "f64k.wav")
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        if f32refs is not None:
            f32refs.close()
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
