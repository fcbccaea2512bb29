"""Meshes of devices and the last modules of the port, against nyx_tpu.

The meshes (`nyx_tpu_torch/parallel/mesh.py`): the Monte Carlo entry
points (`run_until_epoch`, `resume_run_until_epoch`, `run_until_nth_event`,
`run_until_epoch_encke`) and `ScanKalmanOD.process_arc_batch` sharded over
a mesh of CPU devices (a device repeated is a shard, the counterpart of
the 8 virtual CPU devices tests/conftest.py gives JAX), held to the port's
own unsharded runs within 1e-12 km, padding included (on the CPU a batch of
another width rounds a few operations' last bit otherwise, as
test_torch_config3.py's chunked runs do), and one sharded run with Config
2's dynamics held to the reference's unsharded run. The thread safety the
mesh needs: the kernel's and the twin's call counters, the build lock, the
per-thread `xmath.LastCall`, the packed tables.

The leftovers, each on the same numpy inputs as the reference: polyfit,
xmath, the elementary rotations, time (Julian dates, `Unit`, `Duration`),
the Monte Carlo helpers (the same numpy Generator seed, equal to the bit),
`Harmonics` at precision "mixed" with `split_degree` 8, the error classes,
the small API additions, every plot of `plots.py` (each Line2D's data within
1e-9, titles and labels), and tracing (`profile_trace`, `enable_logging`).
Then the API coverage: every public module, class, method and argument of
nyx_tpu has its counterpart in nyx_tpu_torch, but for a listed few.

One file, so that each test worker pays the JAX and torch imports once.
The test marked `cuda` needs only the port; a machine with a card but no
JAX runs it alone with

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_leftovers.py
"""

from __future__ import annotations

import ast
import json
import logging
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import nyx_tpu as R
    from nyx_tpu import errors as rerrors
    from nyx_tpu import plots as rplots
    from nyx_tpu import polyfit as rpolyfit
    from nyx_tpu import time as rtime
    from nyx_tpu import xmath as rxmath
    from nyx_tpu.cosmic import orbit as rorbit
    from nyx_tpu.cosmic import rotations as rrotations
    from nyx_tpu.dynamics import Drag as RDrag
    from nyx_tpu.dynamics import Harmonics as RHarmonics
    from nyx_tpu.dynamics import OrbitalDynamics as ROrbitalDynamics
    from nyx_tpu.dynamics import SolarPressure as RSolarPressure
    from nyx_tpu.dynamics import SpacecraftDynamics as RSpacecraftDynamics
    from nyx_tpu.ephem.almanac import Almanac as RAlmanac
    from nyx_tpu.io.gravity import GravityFieldData as RGravityFieldData
    from nyx_tpu.mc import MonteCarlo as RMonteCarlo
    from nyx_tpu.mc import MvnSpacecraft as RMvnSpacecraft
    from nyx_tpu.mc import StateDispersion as RStateDispersion
    from nyx_tpu.mc import helpers as rhelpers
    from nyx_tpu.md.objective import Objective as RObjective
    from nyx_tpu.md.trajectory import Trajectory as RTrajectory
    from nyx_tpu.od import KfEstimate as RKfEstimate
    from nyx_tpu.od.estimate import Residual as RResidual
    from nyx_tpu.od.position import PositionDevice as RPositionDevice
    from nyx_tpu.od.simulator import TrkConfig as RTrkConfig
    from nyx_tpu.od.solution import ODSolution as RODSolution
    from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
    from nyx_tpu.propagators import Propagator as RPropagator
    from nyx_tpu.tools.porkchop import Porkchop as RPorkchop
except ImportError:  # a machine with a card but no JAX runs the cuda test alone
    jax = R = None

import chip_smoke
import nyx_tpu_torch as P
from nyx_tpu_torch import errors, interop, plots, polyfit, tracing, xmath
from nyx_tpu_torch import time as ptime
from nyx_tpu_torch import _cuda
from nyx_tpu_torch.cosmic import orbit as porbit
from nyx_tpu_torch.cosmic import rotations
from nyx_tpu_torch.cosmic.spacecraft import IDX_CD, IDX_CR, IDX_PROP_MASS
from nyx_tpu_torch.dynamics import (
    Drag, Harmonics, OrbitalDynamics, SolarPressure, SpacecraftDynamics, gravity_pines,
)
from nyx_tpu_torch.ephem import Almanac
from nyx_tpu_torch.io.gravity import GravityFieldData
from nyx_tpu_torch.mc import (
    MonteCarlo, MvnSpacecraft, StateDispersion, dv_execution_error, dv_pointing_error,
    unit_vector_from_seed,
)
from nyx_tpu_torch.md.events import Event
from nyx_tpu_torch.md.objective import Objective
from nyx_tpu_torch.od import (
    GroundStation, KfEstimate, MeasurementType, ScanKalmanOD, SpacecraftUncertainty,
    TrackingArcSim, TrkConfig,
)
from nyx_tpu_torch.od.estimate import Residual
from nyx_tpu_torch.od.noise import StochasticNoise, WhiteNoise
from nyx_tpu_torch.od.position import PositionDevice
from nyx_tpu_torch.od.simulator import Scheduler
from nyx_tpu_torch.od.solution import ODSolution
from nyx_tpu_torch.parallel import mesh as pmesh
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator, integrator
from nyx_tpu_torch.tools.porkchop import Porkchop

needs_jax = pytest.mark.skipif(R is None, reason="needs JAX and nyx_tpu (the reference)")

ROOT = Path(__file__).parents[1]
JGM3 = ROOT / "data" / "JGM3.cof.gz"
CPU = torch.device("cpu")
MESH8 = pmesh.Mesh((CPU,) * 8)
SHARD_KM = 1e-12  # sharded vs unsharded port runs (test_torch_config3.py's chunk bound)
# The adaptive runs' step control raises to a power (the error's 1/8 and
# 1/9), which torch's CPU kernels round otherwise in a batch's vectorized
# body than in its scalar tail (16 doubles a pass with AVX-512): an 8-lane
# shard and a 64-lane batch then part by ~1e-13 s in a step and ~2e-11 km
# after the hour. Those runs are held to WIDTH_KM of the unsharded one, and
# to the bit of the unsharded run in chunks of the shards' width.
WIDTH_KM = 5e-11
MAIN_PATH_KM = 1e-4  # the port vs the reference (test_torch_main_path.py's bound)
LEO = (7136.6, 2e-4, 51.6, 30.0, 65.0, 80.0)


def _leo_mvn(M=None):
    """Config 2's LEO spacecraft (100 kg, 2 m^2 for SRP and drag, Cr 1.8,
    Cd 2.2), dispersed in sma and inc."""
    M = M or P
    epoch = M.Epoch.from_gregorian_utc(2021, 3, 4)
    sc = M.Spacecraft.new(M.Orbit.keplerian(*LEO, epoch, M.Frames.EME2000), 100.0, 0.0, 2.0,
                          2.0, 1.8, 2.2)
    if M is P:
        return epoch, MvnSpacecraft(sc, [StateDispersion("sma", 0.5), StateDispersion("inc", 0.01)])
    return epoch, RMvnSpacecraft(sc, [RStateDispersion("sma", 0.5), RStateDispersion("inc", 0.01)])


def _two_body_prop():
    dyn = SpacecraftDynamics.new(OrbitalDynamics.two_body(P.Frames.EME2000))
    return Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9))


def _gap_km(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a)[:, :3] - np.asarray(b)[:, :3], axis=1).max())


def _hold_sharded(sharded, plain, n, label, same_width=None):
    """The sharded run against the unsharded one (within SHARD_KM, or
    WIDTH_KM where the batch widths round pow apart) and, if given, against
    the unsharded run in chunks of the shards' width (to the bit)."""
    gap = _gap_km(sharded.y_final, plain.y_final)
    print(f"\n{label}: {sharded.n_runs} runs, sharded vs unsharded {gap:.3e} km")
    assert sharded.n_runs == plain.n_runs == n
    assert sharded.n_ok == plain.n_ok == n
    np.testing.assert_array_equal(sharded.y_initial, plain.y_initial)
    assert sharded.device == "cpu"
    if same_width is None:
        assert gap <= SHARD_KM, gap
        np.testing.assert_array_equal(sharded.n_accepted, plain.n_accepted)
        assert sharded.iterations == plain.iterations
        return
    assert gap <= WIDTH_KM, gap
    np.testing.assert_array_equal(sharded.y_final, same_width.y_final)
    np.testing.assert_array_equal(sharded.n_accepted, same_width.n_accepted)
    assert sharded.iterations == same_width.iterations


# ------------------------------------------------------------------ meshes
@pytest.mark.parametrize("n", [64, 20])
def test_run_until_epoch_on_a_mesh(n):
    """Two-body over 1 h on 8 CPU shards: B = 64 (8 a shard) and B = 20
    (padded to 24 with copies of the last draw), against one device."""
    epoch, mvn = _leo_mvn()
    prop, end = _two_body_prop(), epoch + 3600.0
    plain = MonteCarlo(mvn, seed=11).run_until_epoch(prop, None, end, n, device="cpu")
    width = -(-n // MESH8.size)
    chunked = MonteCarlo(mvn, seed=11).run_until_epoch(prop, None, end, n, device="cpu",
                                                       max_lanes_per_call=width)
    sharded = MonteCarlo(mvn, seed=11).run_until_epoch(prop, None, end, n, mesh=MESH8)
    _hold_sharded(sharded, plain, n, f"run_until_epoch B = {n}", chunked)


def test_resume_and_nth_event_on_a_mesh():
    """resume_run_until_epoch (skip 5, 11 runs over 3 shards) and
    run_until_nth_event (12 runs, the first descending node) on a mesh,
    against the same calls on one device; the captures gather whole."""
    epoch, mvn = _leo_mvn()
    prop, end = _two_body_prop(), epoch + 1800.0
    mesh3 = pmesh.Mesh((CPU,) * 3)
    plain = MonteCarlo(mvn, seed=3).resume_run_until_epoch(prop, None, end, 5, 11, device="cpu")
    chunked = MonteCarlo(mvn, seed=3).run_until_epoch(prop, None, end, 11, 5, device="cpu",
                                                      max_lanes_per_call=4)
    sharded = MonteCarlo(mvn, seed=3).resume_run_until_epoch(prop, None, end, 5, 11, mesh3)
    _hold_sharded(sharded, plain, 11, "resume_run_until_epoch", chunked)
    ev = Event("declination", 0.0)
    plain = MonteCarlo(mvn, seed=3).run_until_nth_event(prop, None, 4000.0, ev, 1, 12,
                                                        n_capture=128, device="cpu")
    sharded = MonteCarlo(mvn, seed=3).run_until_nth_event(prop, None, 4000.0, ev, 1, 12,
                                                          mesh=MESH8, n_capture=128)
    chunked = MonteCarlo(mvn, seed=3).run_until_epoch(prop, None, P.Epoch.from_tai_seconds_j2000(
        epoch.to_tai_seconds() + 4000.0), 12, device="cpu", n_capture=128, max_lanes_per_call=2)
    _hold_sharded(sharded, plain, 12, "run_until_nth_event", chunked)
    assert sharded.event_found.all() and plain.event_found.all()
    np.testing.assert_allclose(sharded.event_t, plain.event_t, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(sharded.traj_y, chunked.traj_y)
    assert sharded.traj_y.shape == plain.traj_y.shape
    np.testing.assert_array_equal(sharded.traj_len, plain.traj_len)


def test_encke_on_a_mesh():
    """run_until_epoch_encke (ABM, 2 h) at B = 20 on 8 shards (padded to
    24), the reference's padding case (tests/test_monte_carlo.py:345-362):
    one nominal, its table copied to each shard."""
    epoch, mvn = _leo_mvn()
    prop, end = _two_body_prop(), epoch + 7200.0
    plain = MonteCarlo(mvn, seed=13).run_until_epoch_encke(prop, None, end, 20, integ="abm",
                                                           device="cpu")
    sharded = MonteCarlo(mvn, seed=13).run_until_epoch_encke(prop, None, end, 20, integ="abm",
                                                             mesh=MESH8)
    _hold_sharded(sharded, plain, 20, "Encke ABM")


@needs_jax
def test_sharded_config2_matches_reference():
    """Config 2's dynamics (8x8 JGM3 split, SRP, exponential drag, RK89 at
    1e-9) at B = 16 over 600 s on 8 CPU shards, against the reference's
    unsharded run fed the same initial states (`_y0`)."""
    r_stor = RGravityFieldData.from_cof(JGM3, 8, 8, True, R.Frames.IAU_EARTH)
    r_dyn = RSpacecraftDynamics(
        ROrbitalDynamics.from_model(RHarmonics.from_stor(r_stor, precision="split"),
                                    R.Frames.EME2000),
        (RSolarPressure.default(), RDrag.earth_exp()))
    stor = GravityFieldData.from_cof(JGM3, 8, 8, True, P.Frames.IAU_EARTH)
    dyn = SpacecraftDynamics(
        OrbitalDynamics.from_model(Harmonics.from_stor(stor, precision="split"), P.Frames.EME2000),
        (SolarPressure.default(), Drag.earth_exp()))
    epoch, mvn = _leo_mvn()
    r_epoch, r_mvn = _leo_mvn(R)
    y0 = mvn.sample(16, torch.Generator().manual_seed(5), device="cpu").numpy()
    ref = RMonteCarlo(r_mvn, seed=1).run_until_epoch(
        RPropagator.rk89(r_dyn, RIntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9)),
        RAlmanac(), r_epoch + 600.0, 16, _y0=jnp.asarray(y0))
    res = MonteCarlo(mvn, seed=1).run_until_epoch(
        Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9)),
        Almanac(), epoch + 600.0, 16, mesh=MESH8, _y0=y0)
    gap = _gap_km(res.y_final, ref.y_final)
    print(f"\nConfig 2 dynamics, 8 shards vs the reference unsharded: {gap:.3e} km")
    assert res.n_ok == ref.n_ok == 16
    assert gap < MAIN_PATH_KM, gap


def _od_scene():
    """The two-body 22,000 km scene of test_torch_scan_modes.py through the
    port alone, over its first 2 h: truth, stations, arc and 5 dispersed
    estimates."""
    epoch = P.Epoch.from_gregorian_utc(2020, 1, 1)
    truth = P.Spacecraft.from_orbit(
        P.Orbit.keplerian(22_000.0, 0.01, 30.0, 80.0, 40.0, 0.0, epoch, P.Frames.EME2000))
    prop = Propagator.rk89(SpacecraftDynamics.new(OrbitalDynamics.two_body(P.Frames.EME2000)),
                           IntegratorOptions())
    _, traj = prop.with_state(truth, device="cpu").for_duration_with_traj(7200.0)
    types = (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S)
    stations = [GroundStation.dss65_madrid(10.0), GroundStation.dss34_canberra(10.0),
                GroundStation.dss13_goldstone(10.0)]
    for g in stations:
        g.stochastic_noises = {types[0]: StochasticNoise(WhiteNoise(2.0e-3)),
                               types[1]: StochasticNoise(WhiteNoise(3.0e-6))}
    cfg = TrkConfig(sampling_s=60.0, scheduler=Scheduler(min_samples=5))
    arc = TrackingArcSim.with_seed(stations, traj, {g.name: cfg for g in stations}, seed=0,
                                   device="cpu").generate_measurements()
    rng = np.random.default_rng(42)
    base = SpacecraftUncertainty(nominal=truth, frame="ric", x_km=0.15, y_km=0.15, z_km=0.15,
                                 vx_km_s=5e-6, vy_km_s=5e-6, vz_km_s=5e-6).to_estimate()
    ests = [KfEstimate.from_covar(
        truth.set_vector(epoch, truth.to_vector() + rng.multivariate_normal(np.zeros(9),
                                                                            base.covar)),
        base.covar) for _ in range(5)]
    od = ScanKalmanOD(prop, stations, types=types, resid_rejection_sigmas=4.0, device="cpu")
    return od, arc, ests


def test_process_arc_batch_on_a_mesh():
    """5 filters on a 2-device CPU mesh (padded to 6 with a copy of the
    first) against the port's unsharded batch (test_torch_scan_modes.py
    holds that batch to the reference): estimates within 1e-12 km and
    1e-15 km/s, the same rejections."""
    od, arc, ests = _od_scene()
    plain = od.process_arc_batch(ests, arc)
    sharded = od.process_arc_batch(ests, arc, mesh=pmesh.Mesh((CPU, CPU)))
    assert len(sharded) == len(plain) == 5
    gap = max(float(np.abs(s.y_est[:, :3] - p.y_est[:, :3]).max()) for s, p in zip(sharded, plain))
    print(f"\nprocess_arc_batch, 2 shards vs unsharded: {gap:.3e} km over {len(arc)} rows")
    assert gap <= SHARD_KM
    for s, p in zip(sharded, plain):
        np.testing.assert_array_equal(s.rejected, p.rejected)
        np.testing.assert_allclose(s.y_est[:, 3:6], p.y_est[:, 3:6], rtol=0, atol=1e-15)
        np.testing.assert_allclose(s.covar, p.covar, rtol=1e-12, atol=1e-18)
    assert set(od.stage_walls_s) >= {"s1", "s2", "s3", "s4"}


def test_ensemble_mesh_needs_cuda(monkeypatch):
    """ensemble_mesh() takes every CUDA device; without one it raises and
    never builds a CPU mesh. Explicit devices, repeats included, make one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.ConfigError):
        pmesh.ensemble_mesh()
    m = pmesh.ensemble_mesh([CPU] * 8)
    assert m.size == 8 and m.axis_names == (pmesh.ENSEMBLE_AXIS,)
    with pytest.raises(errors.ConfigError):
        pmesh.Mesh(())
    padded, n_pad = pmesh.pad_to_multiple(np.arange(10.0).reshape(5, 2), 4)
    assert n_pad == 3 and (padded[5:] == padded[4]).all()
    parts = pmesh.shard_ensemble(torch.as_tensor(padded), pmesh.Mesh((CPU,) * 4))
    assert [tuple(p.shape) for p in parts] == [(2, 2)] * 4
    with pytest.raises(errors.ConfigError):
        pmesh.shard_ensemble(torch.zeros(5, 2), pmesh.Mesh((CPU,) * 4))


def test_a_shard_exception_reaches_the_caller(monkeypatch):
    """An exception raised in one shard's thread is raised again in the
    caller, after every thread has ended, whatever the entry point."""
    def boom(k, dev):
        if k == 2:
            raise FloatingPointError(f"shard {k}")
        return k

    with pytest.raises(FloatingPointError, match="shard 2"):
        pmesh.run_on_shards(pmesh.Mesh((CPU,) * 4), boom)
    assert pmesh.run_on_shards(pmesh.Mesh((CPU,) * 3), lambda k, d: k * k) == [0, 1, 4]
    real = integrator.propagate

    def fails_in_shard_3(*a, **kw):
        if threading.current_thread().name.endswith("-3"):
            raise errors.PropagationError("lane blew up in shard 3")
        return real(*a, **kw)

    monkeypatch.setattr(integrator, "propagate", fails_in_shard_3)
    epoch, mvn = _leo_mvn()
    with pytest.raises(errors.PropagationError, match="shard 3"):
        MonteCarlo(mvn, seed=1).run_until_epoch(_two_body_prop(), None, epoch + 60.0, 8,
                                                mesh=pmesh.Mesh((CPU,) * 4))
    assert threading.active_count() == 1 or all(
        not t.name.startswith("mc shard") for t in threading.enumerate())


# ---------------------------------------------------------- thread safety
class _LabelledCuda(torch.Tensor):
    """A CPU tensor that says it is on CUDA, so the twin's CUDA call
    counter runs on the CPU; operations on it return plain tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


def test_counters_and_caches_under_threads():
    """8 threads of the twin at once: the CUDA call counter (added to
    under COUNT_LOCK) loses no count; `LastCall` keeps each thread's
    values apart; the packed table is one tensor per (degree, dtype,
    device) whichever thread asks first; the build lock serializes
    `_cuda.load`."""
    stor = GravityFieldData.from_cof(JGM3, 4, 4, True, P.Frames.IAU_EARTH)
    field = Harmonics.from_stor(stor, precision="f32")
    tab = field.packed_table(0, torch.float32, CPU)
    r = (torch.randn(4, 3, generator=torch.Generator().manual_seed(0)) * 7000.0).float()
    calls, threads_n = 40, 8
    gravity_pines.pines_accel_torch.cuda_calls = 0
    start = threading.Barrier(threads_n)
    tables, outs = [], []

    def work():
        start.wait()
        tables.append(field.packed_table(0, torch.float32, CPU))
        for _ in range(calls):
            out = gravity_pines.pines_accel_torch(r.as_subclass(_LabelledCuda), tab, 0,
                                                  **field.pines_args())
        outs.append(out)

    ts = [threading.Thread(target=work) for _ in range(threads_n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert gravity_pines.pines_accel_torch.cuda_calls == threads_n * calls
    gravity_pines.pines_accel_torch.cuda_calls = 0
    assert all(t is tab for t in tables)
    assert all(torch.equal(o, outs[0]) for o in outs)

    memo, t_key = xmath.LastCall(), torch.zeros(3)
    seen = {}

    def keep(i):
        memo.put("dcm", t_key, i)
        start2.wait()
        seen[i] = memo.peek("dcm", t_key)

    start2 = threading.Barrier(4)
    ts = [threading.Thread(target=keep, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert seen == {0: 0, 1: 1, 2: 2, 3: 3}
    assert memo.peek("dcm", t_key) is None  # this thread put nothing


def test_builds_hold_one_lock(monkeypatch):
    """`_cuda.load` builds under one lock: threads asking at once never
    build side by side (their temporary files would collide)."""
    inside, most = [0], [0]
    guard = threading.Lock()

    def slow_build(name):
        with guard:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        threading.Event().wait(0.02)
        with guard:
            inside[0] -= 1
        return name

    monkeypatch.setattr(_cuda, "_load", slow_build)
    ts = [threading.Thread(target=_cuda.load, args=("pines",)) for _ in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert most[0] == 1


def test_launch_tally_by_thread_keeps_the_kernels_counter():
    """chip_smoke's tally of kernel launches by host thread stands in the
    module's global while it is open: a kernel that adds to its counter
    through that global, as `gravity_pines.pines_accel_cuda` does, still
    counts every launch from every thread, and the kernel is put back."""
    import types

    gp = types.ModuleType("kernel_module")
    exec("import threading\n"
         "COUNT_LOCK = threading.Lock()\n"
         "def pines_accel_cuda(x):\n"
         "    with COUNT_LOCK:\n"
         "        pines_accel_cuda.launches += 1\n"
         "    return x\n"
         "pines_accel_cuda.launches = 0\n", gp.__dict__)
    kernel = gp.pines_accel_cuda
    with chip_smoke._launches_by_thread(gp) as tally:
        gp.pines_accel_cuda.launches = 0
        ts = [threading.Thread(target=lambda: [gp.pines_accel_cuda(k) for k in range(50)],
                               name=f"shard{i}") for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert gp.pines_accel_cuda.launches == 150
    assert gp.pines_accel_cuda is kernel and kernel.launches == 150
    assert dict(tally) == {"shard0": 50, "shard1": 50, "shard2": 50}


@pytest.mark.cuda
def test_shards_on_one_card():
    """Three shards of cuda:0 launch the kernel from three threads, in turn,
    on streams of their own: every launch counted, by the kernel's counter
    and by chip_smoke's tally by thread, results equal to the
    unsharded kernel's to the bit, no twin call on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    stor = GravityFieldData.from_cof(JGM3, 21, 21, True, P.Frames.IAU_EARTH)
    field = Harmonics.from_stor(stor, precision="f32")
    tab = field.packed_table(0, torch.float32, "cuda")
    r = (torch.randn(3000, 3, generator=torch.Generator().manual_seed(1)) * 7000.0).float().cuda()
    whole = gravity_pines.pines_accel_cuda(r, tab, 0, **field.pines_args())
    gravity_pines.pines_accel_cuda.launches = 0
    gravity_pines.pines_accel_torch.cuda_calls = 0
    mesh = pmesh.Mesh(("cuda:0",) * 3)
    with chip_smoke._launches_by_thread(gravity_pines) as tally:
        parts = pmesh.run_on_shards(mesh, lambda k, dev: [gravity_pines.pines_accel_cuda(
            r[k * 1000:(k + 1) * 1000].contiguous(), tab, 0, **field.pines_args())
            for _ in range(50)][-1])
    assert gravity_pines.pines_accel_cuda.launches == 150
    assert sorted(tally.values()) == [50, 50, 50]
    assert gravity_pines.pines_accel_torch.cuda_calls == 0
    assert torch.equal(torch.cat(parts), whole)


# -------------------------------------------------------- module parity
@needs_jax
def test_polyfit_matches_reference():
    """Polynomial, CommonPolynomial and lagrange (host numpy in both) and
    hermite_eval (torch f64 against jnp) on the same samples."""
    coeffs = (1.5, -2.0, 0.25, 3.0)
    p, rp = polyfit.Polynomial(coeffs), rpolyfit.Polynomial(coeffs)
    for t in (-1.3, 0.0, 2.7):
        assert p.eval(t) == rp.eval(t) and p.deriv(t) == rp.deriv(t)
    assert p.derivative() == polyfit.Polynomial(rp.derivative().coefficients)
    assert str(p) == str(rp) and p.order == rp.order and p.coeff_in_order(2) == 0.25
    assert polyfit.Polynomial.from_most_significant(coeffs).coefficients == \
        rpolyfit.Polynomial.from_most_significant(coeffs).coefficients
    for name, args in (("Constant", (2.0,)), ("Linear", (2.0, 1.0)), ("Quadratic", (1.0, 2.0, 3.0))):
        assert getattr(polyfit.CommonPolynomial, name)(*args) == polyfit.Polynomial(
            getattr(rpolyfit.CommonPolynomial, name)(*args).coefficients)
    xs, ys = [0.0, 1.0, 2.5, 4.0], [1.0, -0.5, 2.0, 0.3]
    np.testing.assert_allclose(polyfit.lagrange(xs, ys).coefficients,
                               rpolyfit.lagrange(xs, ys).coefficients, rtol=1e-13, atol=1e-13)
    assert p.eval(torch.tensor([0.5], dtype=torch.float64)).item() == rp.eval(0.5)
    rng = np.random.default_rng(3)
    hx = np.sort(rng.uniform(0.0, 10.0, 5))
    hy, hyd = rng.normal(size=5), rng.normal(size=5)
    for t in (hx[0], 3.3, 7.9):
        v, dv = polyfit.hermite_eval(hx, hy, hyd, t)
        rv, rdv = rpolyfit.hermite_eval(hx, hy, hyd, t)
        assert v.dtype == torch.float64 and v.device.type == "cpu"
        assert abs(float(v) - float(rv)) <= 1e-12 * max(1.0, abs(float(rv)))
        assert abs(float(dv) - float(rdv)) <= 1e-12 * max(1.0, abs(float(rdv)))


@needs_jax
def test_xmath_and_rotations_match_reference():
    """Every xmath function and constant, and rot1-rot3, on the same
    inputs: trig helpers and reductions within 1e-15, gauss_solve within
    1e-12 of the reference's elimination (and of numpy's solve)."""
    rng = np.random.default_rng(7)
    for name in ("PI", "TWO_PI", "DEG2RAD", "RAD2DEG", "TWO_PI_A", "TWO_PI_B", "TWO_PI_C"):
        assert getattr(xmath, name) == getattr(rxmath, name)
    big = np.concatenate([rng.uniform(-1e6, 1e6, 16), [0.0, np.pi, -3 * np.pi]])
    for name in ("reduce_rad", "reduce_deg", "sin_rad", "cos_rad", "sin_deg", "cos_deg"):
        np.testing.assert_allclose(getattr(xmath, name)(torch.tensor(big)).numpy(),
                                   np.asarray(getattr(rxmath, name)(jnp.asarray(big))),
                                   rtol=0, atol=1e-15 * (360.0 if "deg" in name else 1.0))
    s, c = xmath.sincos_deg(torch.tensor(big))
    rs, rc = rxmath.sincos_deg(jnp.asarray(big))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-15)
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=1e-15)
    v, a = rng.normal(size=(6, 3)), rng.normal(size=(6, 3))
    th = rng.uniform(-3.0, 3.0, 6)
    pairs = [
        (xmath.norm(torch.tensor(v), axis=0), rxmath.norm(jnp.asarray(v), axis=0)),
        (xmath.unit(torch.tensor(v)), rxmath.unit(jnp.asarray(v))),
        (xmath.tilde_matrix(torch.tensor(v)), rxmath.tilde_matrix(jnp.asarray(v))),
        (xmath.rotv(torch.tensor(v), torch.tensor(a), torch.tensor(th)),
         rxmath.rotv(jnp.asarray(v), jnp.asarray(a), jnp.asarray(th))),
        (xmath.projv(torch.tensor(v), torch.tensor(a)), rxmath.projv(jnp.asarray(v), jnp.asarray(a))),
    ] + [(getattr(rotations, f)(torch.tensor(th)), getattr(rrotations, f)(jnp.asarray(th)))
         for f in ("rot1", "rot2", "rot3")]
    for mine, ref in pairs:
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0, atol=1e-15)
    m, rhs = rng.normal(size=(4, 9, 9)), rng.normal(size=(4, 9, 2))
    x = xmath.gauss_solve(torch.tensor(m), torch.tensor(rhs))
    assert x.dtype == torch.float64 and tuple(x.shape) == (4, 9, 2)
    np.testing.assert_allclose(x.numpy(), np.asarray(rxmath.gauss_solve(jnp.asarray(m),
                                                                         jnp.asarray(rhs))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(m, rhs), rtol=1e-10, atol=1e-10)


@needs_jax
def test_time_matches_reference():
    """Unit, Duration's constructors, accessors and arithmetic, Epoch's
    Julian dates and GPS seconds, and J2000_TAI, on the same numbers."""
    for u in ("Nanosecond", "Microsecond", "Millisecond", "Second", "Minute", "Hour", "Day",
              "Week"):
        assert getattr(P.Unit, u) == getattr(rtime.Unit, u)
    for name in ("JD_J2000", "MJD_OFFSET"):
        assert getattr(ptime, name) == getattr(rtime, name)
    assert ptime.J2000_TAI.to_tai_seconds() == rtime.J2000_TAI.to_tai_seconds() == 0.0
    for ctor, x in (("from_seconds", 12.5), ("from_minutes", -3.25), ("from_hours", 7.0),
                    ("from_days", 1.75)):
        d, rd = getattr(P.Duration, ctor)(x), getattr(rtime.Duration, ctor)(x)
        assert d.seconds == rd.seconds and d.days == rd.days and str(d) == str(rd)
        assert d.is_negative() == rd.is_negative()
        assert d.to_unit(P.Unit.Minute) == rd.to_unit(rtime.Unit.Minute)
        assert (d + d).seconds == (rd + rd).seconds and (-d).seconds == (-rd).seconds
        assert (d * 3).seconds == (rd * 3).seconds and (2 * d).seconds == (2 * rd).seconds
        assert (d / 4).seconds == (rd / 4).seconds and d / d == rd / rd
        assert abs(d).seconds == abs(rd).seconds and (d - d).seconds == 0.0
    e = P.Epoch.from_gregorian_utc(2021, 3, 4, 5, 6, 7.25)
    re = R.Epoch.from_gregorian_utc(2021, 3, 4, 5, 6, 7.25)
    for acc in ("to_jde_tai", "to_mjd_tai", "to_jde_tt", "to_jde_tdb", "to_jde_utc"):
        assert getattr(e, acc)() == getattr(re, acc)()
    for ctor, x in (("from_gps_seconds_j2000", 6.7e8), ("from_jde_tai", 2459277.71),
                    ("from_mjd_tai", 59277.2), ("from_jde_tdb", 2459277.71),
                    ("from_jde_utc", 2459277.71)):
        a, b = getattr(P.Epoch, ctor)(x), getattr(R.Epoch, ctor)(x)
        assert (a.tai_int, a.tai_frac) == (b.tai_int, b.tai_frac)
    assert (e + P.Duration.from_hours(1)).to_tai_seconds() == \
        (re + R.Duration.from_hours(1)).to_tai_seconds()


@needs_jax
def test_helpers_match_reference_to_the_bit():
    """unit_vector_from_seed, dv_pointing_error and dv_execution_error with
    the same numpy Generator seed: equal to the bit, and the same errors."""
    def run(mod):
        rng = np.random.default_rng(99)
        u1, u5 = mod.unit_vector_from_seed(rng), mod.unit_vector_from_seed(rng, 5)
        dv = np.array([[0.01, -0.002, 0.003]] * 5)
        cur = u5 + 0.1
        return (u1, u5, mod.dv_pointing_error(cur, dv, 0.1, rng),
                mod.dv_execution_error(cur, dv, 0.1, 0.05, rng))

    for mine, ref in zip(run(P.mc.helpers), run(rhelpers)):
        np.testing.assert_array_equal(mine, ref)
    assert unit_vector_from_seed is P.mc.helpers.unit_vector_from_seed
    rng = np.random.default_rng(0)
    with pytest.raises(errors.MonteCarloError):
        dv_pointing_error(np.ones(3), np.ones(3), 1.5, rng)
    with pytest.raises(errors.MonteCarloError):
        dv_execution_error(np.ones(3), np.zeros(3), 0.1, 0.1, rng)


@needs_jax
def test_mixed_harmonics_split_degree_matches_reference():
    """Harmonics at precision "mixed" with split_degree 8 (degrees up to 8
    at f64, the rest at f32 from q_lo = 8: the Moon's setting) on a 12x12
    JGM3 field, against the reference's mixed evaluation on the CPU, and
    `from_stor(jvp_degree=)`. The f32 part rounds alike up to
    reassociation: held to 1e-6 of the field's acceleration."""
    r_stor = RGravityFieldData.from_cof(JGM3, 12, 12, True, R.Frames.IAU_EARTH)
    stor = GravityFieldData.from_cof(JGM3, 12, 12, True, P.Frames.IAU_EARTH)
    ref = RHarmonics.from_stor(r_stor, precision="mixed", split_degree=8)
    mine = Harmonics.from_stor(stor, precision="mixed", split_degree=8, jvp_degree=6)
    assert (mine.split_degree, mine.jvp_degree) == (8, 6)
    assert Harmonics.from_stor(stor).split_degree == Harmonics.MIXED_SPLIT_DEGREE == 3
    rng = np.random.default_rng(4)
    r = rng.normal(size=(16, 3))
    r = r / np.linalg.norm(r, axis=1, keepdims=True) * rng.uniform(6600.0, 8000.0, (16, 1))
    a = mine.accel_body_fixed(torch.tensor(r)).numpy()
    a_ref = np.asarray(ref.accel_body_fixed(jnp.asarray(r)))
    f64 = Harmonics.from_stor(stor).accel_body_fixed(torch.tensor(r)).numpy()
    rel = float(np.abs(a - a_ref).max() / np.abs(a_ref).max())
    print(f"\nmixed at split 8 vs the reference: {rel:.3e} of the acceleration; "
          f"vs f64 {float(np.abs(a - f64).max() / np.abs(f64).max()):.3e}")
    assert rel < 1e-6
    split3 = Harmonics.from_stor(stor, precision="mixed").accel_body_fixed(torch.tensor(r))
    assert not torch.equal(split3, torch.tensor(a))  # the split moved the f32 part


@needs_jax
def test_errors_and_small_api_match_reference():
    """The error classes with the reference's bases; the state-vector
    indices; rss_orbit_errors; Objective.assess; TrkConfig.from_sample_rate;
    StochasticNoise.ZERO; the position device's azimuth_elevation_range."""
    for name in rerrors.__all__:
        mine, ref = getattr(errors, name), getattr(rerrors, name)
        assert [b.__name__ for b in mine.__bases__] == [b.__name__ for b in ref.__bases__], name
    assert (IDX_CR, IDX_CD, IDX_PROP_MASS) == (6, 7, 8)
    epoch = P.Epoch.from_gregorian_utc(2021, 3, 4)
    a = P.Orbit.keplerian(*LEO, epoch, P.Frames.EME2000)
    b = P.Orbit.keplerian(7137.0, 2e-4, 51.6, 30.0, 65.0, 80.1, epoch, P.Frames.EME2000)
    r_epoch = R.Epoch.from_gregorian_utc(2021, 3, 4)
    ra = R.Orbit.keplerian(*LEO, r_epoch, R.Frames.EME2000)
    rb = R.Orbit.keplerian(7137.0, 2e-4, 51.6, 30.0, 65.0, 80.1, r_epoch, R.Frames.EME2000)
    np.testing.assert_allclose(porbit.rss_orbit_errors(a, b), rorbit.rss_orbit_errors(ra, rb),
                               rtol=1e-12)
    y = P.Spacecraft.from_orbit(a).to_vector()
    for obj, robj in ((Objective("sma", 7136.0, 1.0), RObjective("sma", 7136.0, 1.0)),
                      (Objective("inc", 51.0, 0.1), RObjective("inc", 51.0, 0.1))):
        ok, err = obj.assess(y, a.frame.mu)
        rok, rerr = robj.assess(jnp.asarray(y), ra.frame.mu)
        assert ok == bool(rok) and abs(err - float(rerr)) < 1e-9
    cfg, rcfg = TrkConfig.from_sample_rate(P.Duration(30.0)), RTrkConfig.from_sample_rate(30.0)
    assert cfg.sampling_s == rcfg.sampling_s and cfg.scheduler.handoff == rcfg.scheduler.handoff
    assert StochasticNoise.ZERO.covariance() == 1e-32
    rv = np.array([[7000.0, 100.0, -50.0, 0.0, 7.5, 0.0]])
    az, el, rng_km, rr = PositionDevice().azimuth_elevation_range(torch.zeros(1),
                                                                  torch.tensor(rv))
    raz, rel, rrng, rrr = RPositionDevice().azimuth_elevation_range(0.0, jnp.asarray(rv[0]))
    assert (float(az[0]), float(el[0]), float(rr[0])) == (float(raz), float(rel), float(rrr))
    assert abs(float(rng_km[0]) - float(rrng)) < 1e-12


# ------------------------------------------------------------------- plots
def _kepler_nodes(M):
    """A LEO's two-body states every 60 s over 3 h, from the port's Kepler
    solver, as a trajectory of package M (the same arrays for both)."""
    epoch = P.Epoch.from_gregorian_utc(2021, 3, 4)
    o = P.Orbit.keplerian(*LEO, epoch, P.Frames.EME2000)
    ts = np.arange(0.0, 3 * 3600.0 + 1.0, 60.0)
    r0 = torch.tensor(np.asarray(o.r_km))[None].expand(len(ts), 3)
    v0 = torch.tensor(np.asarray(o.v_km_s))[None].expand(len(ts), 3)
    r, v = porbit.keplerian_propagate(r0, v0, o.frame.mu, torch.tensor(ts))
    ys = np.concatenate([r.numpy(), v.numpy(), np.tile([1.8, 2.2, 0.0], (len(ts), 1))], axis=1)
    if M is P:
        return interop.trajectory_from_numpy(epoch.to_tai_seconds(), ts, ys)
    r_epoch = R.Epoch.from_tai_seconds_j2000(epoch.to_tai_seconds())
    sc = R.Spacecraft.from_orbit(R.Orbit.cartesian(*ys[0, :6], r_epoch, R.Frames.EME2000))
    return RTrajectory(r_epoch, ts, ys, sc.set_vector(r_epoch, ys[0]))


def _od_solution(M, traj):
    """An ODSolution of 30 rows every 6 min along `traj`: estimates 100 m
    off with shrinking covariances, residuals with two rejections, gains,
    and filter-smoother ratios, the same numbers for either package."""
    rng = np.random.default_rng(8)
    sol = (RODSolution if M is R else ODSolution)()
    ratios = []
    for i in range(30):
        t = 360.0 * i
        y = np.asarray(traj.interpolate(t))[:9] + np.r_[rng.normal(size=3) * 0.1, np.zeros(6)]
        cov = np.diag(np.r_[np.full(3, 1e-2 / (1 + i)), np.full(3, 1e-8 / (1 + i)),
                            np.full(3, 1e-10)])
        e_tai = traj.epoch0.to_tai_seconds() + t
        if M is R:
            epoch = R.Epoch.from_tai_seconds_j2000(e_tai)
            sc = traj.template.set_vector(epoch, y)
            est, res_cls = RKfEstimate.from_covar(sc, cov), RResidual
        else:
            est, res_cls = interop.kf_estimate_from_numpy(y, cov, e_tai), Residual
            epoch = est.epoch
        ratio = float(rng.normal() * 1.5)
        rej = i in (7, 19)
        resid = res_cls(epoch, "dss65", ("range_km",), np.array([0.01 * ratio]),
                        np.array([0.001 * ratio]), ratio, rej)
        sol.append(est, resid, None if rej else rng.normal(size=(9, 2)) * 1e-3)
        ratios.append(rng.normal(size=9))
    sol.filter_smoother_ratios = ratios
    return sol


def _porkchop(M):
    rng = np.random.default_rng(2)
    ep = (R.Epoch if M is R else P.Epoch).from_gregorian_utc(2020, 7, 1)
    dep = [ep + 86_400.0 * k for k in range(6)]
    arr = [ep + 86_400.0 * (180 + 5 * k) for k in range(7)]
    grids = [rng.uniform(5.0, 40.0, (6, 7)) for _ in range(4)]
    return (RPorkchop if M is R else Porkchop)(dep, arr, *grids)


def _figure_data(fig):
    """Every axes' title and labels, its lines' data, its collections'
    offsets, and the figure's suptitle."""
    out = {"suptitle": fig._suptitle.get_text() if fig._suptitle else None, "axes": []}
    for ax in fig.axes:
        lines = []
        for ln in ax.get_lines():
            data = ln.get_data_3d() if hasattr(ln, "get_data_3d") else ln.get_data()
            lines.append([np.asarray(d, dtype=np.float64) for d in data])
        cols = [np.asarray(c.get_offsets(), dtype=np.float64) for c in ax.collections
                if hasattr(c, "get_offsets") and not hasattr(c, "levels")]
        out["axes"].append(dict(title=ax.get_title(), xlabel=ax.get_xlabel(),
                                ylabel=ax.get_ylabel(), lines=lines, cols=cols))
    return out


def _same_figures(mine, ref, label):
    a, b = _figure_data(mine), _figure_data(ref)
    assert a["suptitle"] == b["suptitle"], label
    assert len(a["axes"]) == len(b["axes"]), label
    n_lines = 0
    for x, y in zip(a["axes"], b["axes"]):
        assert (x["title"], x["xlabel"], x["ylabel"]) == (y["title"], y["xlabel"], y["ylabel"])
        assert len(x["lines"]) == len(y["lines"]) and len(x["cols"]) == len(y["cols"]), label
        for lx, ly in zip(x["lines"], y["lines"]):
            for dx, dy in zip(lx, ly):
                np.testing.assert_allclose(dx, dy, rtol=1e-9, atol=1e-9, err_msg=label)
            n_lines += 1
        for cx, cy in zip(x["cols"], y["cols"]):
            np.testing.assert_allclose(cx, cy, rtol=1e-9, atol=1e-9, err_msg=label)
    return n_lines


@needs_jax
def test_plots_match_reference():
    """Every plot of plots.py from both packages on equivalent inputs:
    each Line2D's data (and each scatter's points) within 1e-9, the titles
    and labels equal; the contour levels of the porkchop equal."""
    import matplotlib.pyplot as plt

    traj, rtraj = _kepler_nodes(P), _kepler_nodes(R)
    other = interop.trajectory_from_numpy(
        traj.epoch0.to_tai_seconds(), traj.ts, traj.ys + np.r_[1e-3, 0, 0, 0, 1e-6, 0, 0, 0, 0])
    rother = RTrajectory(rtraj.epoch0, rtraj.ts, other.ys.copy(), rtraj.template)
    sol, rsol = _od_solution(P, traj), _od_solution(R, rtraj)
    cases = [
        ("plot_traj", (traj,), (rtraj,), {}),
        ("plot_orbital_elements", (traj,), (rtraj,), {}),
        ("plot_groundtrack", (traj,), (rtraj,), {}),
        ("plot_covar", (sol,), (rsol,), {}),
        ("plot_residuals", (sol,), (rsol,), {}),
        ("plot_od_dashboard", (sol, traj), (rsol, rtraj), {}),
        ("plot_kalman_gains", (sol,), (rsol,), {}),
        ("plot_filter_smoother_ratios", (sol,), (rsol,), {}),
        ("plot_orbital_element_uncertainty", (sol,), (rsol,), {}),
        ("plot_ric_diff", (traj, other), (rtraj, rother), {}),
        ("plot_residual_autocorr", (sol,), (rsol,), {}),
        ("plot_porkchop", (_porkchop(P),), (_porkchop(R),), {}),
    ]
    total = 0
    for name, args, rargs, kw in cases:
        extra = {"device": "cpu"} if name == "plot_groundtrack" else {}
        mine = getattr(plots, name)(*args, show=False, **kw, **extra)
        ref = getattr(rplots, name)(*rargs, show=False, **kw)
        total += _same_figures(mine, ref, name)
        if name == "plot_porkchop":
            np.testing.assert_allclose(mine.axes[0].collections[0].levels,
                                       ref.axes[0].collections[0].levels, rtol=1e-12)
        plt.close(mine)
        plt.close(ref)
    print(f"\nplots: {len(cases)} figures, {total} lines held within 1e-9")
    assert total > 20
    np.testing.assert_array_equal(plots.residual_autocorr(np.arange(12.0), 5),
                                  rplots.residual_autocorr(np.arange(12.0), 5))


# ----------------------------------------------------------------- tracing
def test_profile_trace_and_logging(tmp_path, monkeypatch):
    """profile_trace writes a Chrome trace on the CPU holding the regions
    `annotate` names, those of a mesh's worker threads included;
    enable_logging honours NYX_LOG."""
    with tracing.profile_trace(tmp_path / "tr", cuda=False) as session:
        with tracing.annotate("outer region"):
            pmesh.run_on_shards(pmesh.Mesh((CPU,) * 2),
                                lambda k, d: (torch.ones(8, 8) @ torch.ones(8, 8)).sum(),
                                "probe")
    assert session.trace_path.exists() and session.trace_path.parent == tmp_path / "tr"
    names = {e.get("name") for e in json.loads(session.trace_path.read_text())["traceEvents"]}
    assert {"outer region", "probe 0 on cpu", "probe 1 on cpu"} <= names
    monkeypatch.setenv("NYX_LOG", "debug")
    log = tracing.enable_logging()
    assert log.name == "nyx_tpu_torch" and log.level == logging.DEBUG and log.handlers
    assert tracing.enable_logging("warning").level == logging.WARNING
    assert P.enable_logging is tracing.enable_logging and P.annotate is tracing.annotate


# ------------------------------------------------------------ API coverage
# Names of nyx_tpu with no counterpart, each with its reason. The TPU-only
# code of ROADMAP.md's Queue 1 item 9 (whole modules, then members and
# arguments), and renames.
TPU_ONLY_MODULES = {
    "aot": "AOT cache for remote XLA compiles",
    "compileopts": "XLA compiler options",
    "native": "the reference's C++ Hermite; the port interpolates in torch",
    "dynamics.gravity_pallas": "the Pallas wrapper; the kernel is csrc/pines.cu",
}
ALLOWED_GAPS = {
    ("propagators.integrator", "PropCarry"): "the while-loop carry of the XLA integrator",
    ("propagators.integrator", "propagate", "stage_mode"): "TPU knob (options.py:28-61)",
    ("propagators.integrator", "propagate", "steps_per_iter"): "TPU knob (options.py:28-61)",
    ("propagators.options", "IntegratorOptions", "stage_mode"): "TPU knob",
    ("propagators.options", "IntegratorOptions", "steps_per_iter"): "TPU knob",
    ("propagators.options", "IntegratorOptions", "loop_mode"): "TPU knob",
    ("propagators.options", "IntegratorOptions", "scan_iterations"): "loop_mode's trip count",
    ("propagators.options", "IntegratorOptions", "combo_precision"): "TPU knob (combo32)",
    ("propagators.options", "IntegratorOptions", "min_lanes"): "TPU knob",
    ("od.scan_filter", "ScanKalmanOD", "__init__", "aot_dir"): "AOT cache for XLA compiles",
    ("od.scan_filter", "ScanKalmanOD", "aot_dir"): "AOT cache for XLA compiles",
    ("mc.multivariate", "MvnSpacecraft", "sample", "key"):
        "a jax random key; the port draws from a torch.Generator",
    ("dynamics.gravity", "Harmonics", "c_nm"): "a content digest that keys XLA's jit cache",
    ("dynamics.gravity", "Harmonics", "UNROLL_MAX_DEGREE"): "XLA's unrolled-recursion limit",
    # renames: the port's station methods take TDB seconds as `t_tdb`
    ("od.ground_station", "GroundStation", "inertial_posvel", "t_tdb_s"): "renamed t_tdb",
    ("od.ground_station", "GroundStation", "sez_state", "t_tdb_s"): "renamed t_tdb",
    ("od.ground_station", "GroundStation", "azimuth_elevation_range", "t_tdb_s"): "renamed t_tdb",
}


def _public_api(pkg: str) -> dict:
    """{module: {name: args list, member dict, or "const"}} of a package's
    public modules, from the source alone: functions with their argument
    names, classes with their methods, class attributes and the attributes
    their methods set on self, and module constants and re-exports."""
    base = ROOT / pkg
    out = {}
    for f in sorted(base.rglob("*.py")):
        parts = f.relative_to(base).with_suffix("").parts
        if any(p.startswith("_") and p != "__init__" for p in parts):
            continue
        names = {}
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
                names[node.name] = _args(node)
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                names[node.name] = _members(node)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for t in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                    if isinstance(t, ast.Name) and not t.id.startswith("_"):
                        names[t.id] = "const"
            elif isinstance(node, ast.ImportFrom) and node.level and parts[-1] == "__init__":
                for a in node.names:
                    names.setdefault(a.asname or a.name, "const")
        out[".".join(p for p in parts if p != "__init__")] = names
    return out


def _args(fn) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if not x.arg.startswith("_") and x.arg not in ("self", "cls")]


def _members(cls) -> dict:
    out = {}
    for b in cls.body:
        if isinstance(b, ast.FunctionDef):
            if not b.name.startswith("_") or b.name == "__init__":
                out[b.name] = _args(b)
            for n in ast.walk(b):
                if (isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store)
                        and isinstance(n.value, ast.Name) and n.value.id == "self"
                        and not n.attr.startswith("_")):
                    out.setdefault(n.attr, None)
        elif isinstance(b, (ast.Assign, ast.AnnAssign)):
            for t in (b.targets if isinstance(b, ast.Assign) else [b.target]):
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out[t.id] = None
    return out


def test_api_coverage():
    """Every public module, function, class, method, class attribute and
    argument of nyx_tpu has its counterpart in nyx_tpu_torch, but for the
    listed TPU-only names and renames; and every listed gap is still a gap
    (a stale entry fails)."""
    ref, port = _public_api("nyx_tpu"), _public_api("nyx_tpu_torch")
    missing, used = [], set()
    for mod, names in ref.items():
        if mod.split(".")[0] in TPU_ONLY_MODULES or mod in TPU_ONLY_MODULES:
            used.add(mod.split(".")[0] if mod.split(".")[0] in TPU_ONLY_MODULES else mod)
            continue
        if mod not in port:
            missing.append((mod,))
            continue
        for name, spec in names.items():
            key = (mod, name)
            if name not in port[mod]:
                (used.add(key) if key in ALLOWED_GAPS else missing.append(key))
                continue
            mine = port[mod][name]
            if isinstance(spec, list) and isinstance(mine, list):
                for arg in spec:
                    if arg not in mine:
                        k = key + (arg,)
                        (used.add(k) if k in ALLOWED_GAPS else missing.append(k))
            elif isinstance(spec, dict):
                mine = mine if isinstance(mine, dict) else {}
                for member, args in spec.items():
                    k = key + (member,)
                    if member not in mine:
                        (used.add(k) if k in ALLOWED_GAPS else missing.append(k))
                        continue
                    for arg in args or ():
                        if mine[member] is not None and arg not in mine[member]:
                            ka = k + (arg,)
                            (used.add(ka) if ka in ALLOWED_GAPS else missing.append(ka))
    assert not missing, f"no counterpart in nyx_tpu_torch: {missing}"
    stale = (set(ALLOWED_GAPS) | set(TPU_ONLY_MODULES)) - used
    assert not stale, f"listed gaps that are no longer gaps: {stale}"
