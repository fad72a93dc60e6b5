"""dsp_tpu_torch's float32 matrix4 and matrix4_mb against dsp_tpu float64,
on the CPU: the control split, as tests/test_f32_accuracy.py's
TestMatrix4ControlSplit and TestMatrix4MbControlSplit hold dsp_tpu's own
float32 path, on their signal:
* the float32 audio path under control pinned from dsp_tpu float64's run
  (its coefficient sets, and matrix4_mb's bands, rounded to float32):
  within -120 dBFS of dsp_tpu float64;
* the full float32 run (control included: the engines' decisions flip under
  rounding, PARITY.md:192-214): within -100 dBFS (matrix4) and -95 dBFS
  (matrix4_mb), each pinned ~10 dB above its measurement.
Then a float32 matrix4 state crossing both ways between the port and
dsp_tpu's float32 step, against the same dsp_tpu float64 render.

dsp_tpu's float64 upmixes run here once, in a module fixture that every
test of the file reads. dsp_tpu's float32 matrix4 step runs its control
path in two-float32 and compiles for about a minute; it is jitted exactly
as TestMatrix4ControlSplit jits it (`jax.jit(eff.step)` on the state0 tree
cast to float32 and a float32 block of 2048), so that within one pytest
run dsp_tpu's persistent compile cache serves the second compile.
"""

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from test_torch_f32_matrix4 import B, SPECS, _port_effect, split_signal
from torch_parity import FS, dbfs, worst_dbfs

N_BLOCKS = 8  # 0.37 s: the control split's signal at eight blocks of 2048
CROSS_BLOCKS = 2  # the crossing: two blocks in each package
BUDGET_DBFS = -120.0
ACTIVE_DBFS = -40.0


def _dsp_effect(spec):
    from dsp_tpu.chain import build_chain_from_string
    from dsp_tpu.core.types import StreamInfo

    chain = build_chain_from_string(spec, StreamInfo(FS, 2))
    return next(e for e in chain.effects if type(e).__name__.startswith("Matrix4"))


def _dsp_f64_run(spec, x):
    """dsp_tpu float64's effect over x, block by block, _control then
    _audio (jitted): its output, and each block's control as the port's
    _audio takes it, the coefficient sets captured where they pass
    dsp_tpu's optimization barrier (and matrix4_mb's bands)."""
    import jax
    import jax.numpy as jnp

    eff = _dsp_effect(spec)
    holder = {}
    barrier = jax.lax.optimization_barrier

    def spy(t):
        holder["ics"] = t[0]
        return barrier(t)

    def control(state, xb):
        ctl, vals, _ = eff._control(state, xb)
        return ctl, vals, holder.pop("ics")

    jax.lax.optimization_barrier = spy
    try:
        control_j = jax.jit(control)
        st = jax.tree_util.tree_map(jnp.asarray, eff.state_for_block(B))
        audio_j = jax.jit(eff._audio)
        ys, ctls = [], []
        for b in range(len(x) // B):
            xb = jnp.asarray(x[b * B:(b + 1) * B])
            ctl, vals, ics = control_j(st, xb)
            st, y = audio_j(st, xb, vals, ctl)
            ys.append(np.asarray(y))
            pinned = {"ics": np.array(ics)}
            if "bands" in ctl:
                pinned["bands"] = np.array(ctl["bands"]).reshape(B, -1)
            ctls.append(pinned)
    finally:
        jax.lax.optimization_barrier = barrier
    return np.concatenate(ys), ctls


@pytest.fixture(scope="module")
def dsp64():
    """dsp_tpu float64 on the control-split signal, for both upmixes."""
    x = split_signal(N_BLOCKS * B)
    return x, {spec: _dsp_f64_run(spec, x) for spec in SPECS}


# (full float32 run's bound, its pin ~10 dB above the measurement; the
# pinned-control audio path's measurement, for the record)
SPLIT = {
    "matrix4 -6": (-100.0, -132.0),  # full run measured -142.4; pinned control -141.1
    "matrix4_mb -6": (-95.0, -96.0),  # full run -105.8; pinned control -126.8
}
CROSS_PIN_DBFS = -120.0  # the crossing's pin: measured -131.2 (dsp_tpu first), -131.4


@pytest.mark.parametrize("spec", SPECS)
def test_control_split_f32(spec, dsp64):
    """TestMatrix4ControlSplit / TestMatrix4MbControlSplit for the port: on
    the same signal, every output column active (peak above -40 dBFS); the
    port's float32 audio path with dsp_tpu float64's control pinned within
    -120 dBFS of dsp_tpu float64; the port's whole float32 step within its
    bound and pin."""
    x, runs = dsp64
    y64, ctls = runs[spec]
    peaks = [dbfs(float(np.abs(y64[:, c]).max())) for c in range(y64.shape[1])]
    assert y64.shape[1] == 4 and min(peaks) > ACTIVE_DBFS, peaks
    e, s32 = _port_effect(spec, torch.float32)
    _, sp = _port_effect(spec, torch.float32)
    y32, yp = [], []
    for b in range(N_BLOCKS):
        xb = torch.as_tensor(x[b * B:(b + 1) * B], dtype=torch.float32)
        s32, y = e.step(s32, xb)
        y32.append(y)
        pinned = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in ctls[b].items()}
        sp, y = e._audio(sp, xb, dict(pinned, aux=sp["aux"]))
        yp.append(y)
    y32, yp = (torch.cat(ys).double().numpy() for ys in (y32, yp))
    full, pin = worst_dbfs(y32, y64), worst_dbfs(yp, y64)
    print(f"{spec}: peaks {[round(p, 1) for p in peaks]} dBFS; pinned control {pin:.1f}, "
          f"full float32 {full:.1f} dBFS against dsp_tpu f64")
    assert pin <= BUDGET_DBFS
    bound, pinned_full = SPLIT[spec]
    assert full <= bound
    assert full <= pinned_full


# --- the parts: float32 plain versions against float64 fed the same values ----


def _cast_state(st, dt):
    """tests/test_f32_accuracy.py's cast_state: every float64 leaf to dt."""
    import jax

    def cv(a):
        a = np.asarray(a)
        return a.astype(dt) if a.dtype == np.float64 else a

    return jax.tree_util.tree_map(cv, st)


def test_matrix4_f32_state_crosses_packages(dsp64):
    """CROSS_BLOCKS float32 blocks of matrix4 in one package, the state
    handed over leaf by leaf (the checkpoint's leaves, in jax's order),
    CROSS_BLOCKS more in the other, both ways round (one jitted dsp_tpu
    step serves both): within the budget of dsp_tpu float64's
    uninterrupted pass (the module's render), and pinned ~10 dB above the
    measurement; the handed-over leaves float32 (and bool, int64) in both."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu_torch.convert import flatten_states, unflatten_states

    x, runs = dsp64
    n = CROSS_BLOCKS
    blocks = [x[i * B:(i + 1) * B] for i in range(2 * n)]
    whole = runs["matrix4 -6"][0][:2 * n * B]
    eff = _dsp_effect("matrix4 -6")
    step_j = jax.jit(eff.step)
    s0 = eff.state0()
    port, _ = _port_effect("matrix4 -6", torch.float32)

    def port_state0():
        _, st = _port_effect("matrix4 -6", torch.float32)
        return {k: v for k, v in st.items() if k != "aux"}  # dsp_tpu's state0 tree

    def to_port(jst):
        leaves = [torch.as_tensor(np.array(a)) for a in jax.tree_util.tree_leaves(jst)]
        return unflatten_states(port_state0(), leaves)

    def to_dsp(tst):
        leaves = [t.numpy() for t in flatten_states(tst)[0]]
        return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(s0), leaves)

    def run_dsp(st, xs):
        ys = []
        for xb in xs:
            st, y = step_j(st, jnp.asarray(xb, jnp.float32))
            ys.append(np.asarray(y, np.float64))
        return st, ys

    def run_port(st, xs):
        ys = []
        for xb in xs:
            st, y = port.step(st, torch.as_tensor(xb, dtype=torch.float32))
            ys.append(y.double().numpy())
        return st, ys

    for first in ("dsp_tpu", "dsp_tpu_torch"):
        if first == "dsp_tpu":
            st, ys = run_dsp(_cast_state(s0, np.float32), blocks[:n])
            handed = to_port(st)
            st, ys2 = run_port(handed, blocks[n:])
            t = int(st["ev"]["t"])
        else:
            st, ys = run_port(port_state0(), blocks[:n])
            t = int(st["ev"]["t"])
            handed = to_dsp(st)
            st, ys2 = run_dsp(handed, blocks[n:])
        dtypes = {str(np.asarray(a).dtype) for a in jax.tree_util.tree_leaves(handed)}
        assert dtypes == {"float32", "bool", "int64"}, dtypes
        err = worst_dbfs(np.concatenate(ys + ys2), whole)
        print(f"{first} first: {err:.1f} dBFS against dsp_tpu f64; t = {t}")
        assert t == (2 * n if first == "dsp_tpu" else n) * B // 32
        assert err <= BUDGET_DBFS
        assert err <= CROSS_PIN_DBFS
