#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives nyx_tpu_torch's Monte Carlo main path (Config 2 of BASELINE.md: a
10,000-lane LEO ensemble, RK89 adaptive at 1e-9, 21x21 JGM3 at split
precision, exponential drag, SRP with an Earth shadow, one day) on the card,
through the same entry points a user calls. Phases, in order; any failure
raises and exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build the Pines kernel (csrc/pines.cu) from the checkout, and, where
   `--parent DIR` names a checkout of the parent commit, that tree's own
   kernel behind its own wrapper;
3. hold the kernel against its torch twin on the card (21x21 split at
   q_lo 0 and 3, a 12x6 rectangular field, 70x70 JGM3 split at q_lo 0 and
   3, and JGM3 extended with Kaula-rule coefficients to 120x120 and
   160x160, whose tables stream; each at B = 10,000, a ragged 37 and the
   single lane of the OD leg's propagations; phase 6d's 8x8 split field
   at q_lo 0 on GEO radii, at its B = 25 and 4; and phase 6f's 80x80 lunar
   field, streamed, at q_lo 3 on lunar radii, at B = 1, its STM batch 288
   and 10,000), and time the kernel on the card at B = 10,000 beside its
   bound, the lunar field at B = 1 and 288, and the twin and the parent's
   kernel at 21x21;
4. run the main path, after a 120 s warm-up arc, and count kernel launches;
5. rerun 64 of its lanes over the day's first 2 h through the kernel and
   with the gravity twin forced, and compare finals;
6. the same ensemble with 70x70 JGM3 split gravity over half an hour,
   through the kernel, and its 64-lane twin rerun;
6b. the bench's OD leg (bench.py:279-404) through the port: a one-day
   truth by `for_duration_with_traj`, DSS-65/34/13 range and Doppler every
   60 s by `TrackingArcSim`, and `ScanKalmanOD` (CKF, stm_jvp_degree 8,
   f32 algebra) over the whole arc after a 2-hour warm-up arc, timed, with
   its kernel launches counted; the bench's 100 m guard against the
   truth; the warm-up arc again with the gravity twin forced (every row
   within 1e-3 km of the warm-up's) and with f64 algebra
   (TestF32FilterAlgebra's bounds);
6c. the bench's flagship OD leg (bench.py:407-434) on 6b's truth: the
   same stations two-way (60 s integration), simulated by
   `TrackingArcSim`, and the segmented EKF (`variant="ekf"`, SNC, 3-sigma
   gate, stm_jvp_degree 8, f32 algebra) from a dispersed start, after a
   2-hour warm-up arc, timed over the whole arc with its kernel launches
   counted; the bench's 100 m guard; the warm-up arc again through the
   gravity twin (every row within 1e-3 km of the warm-up's) and with f64
   algebra (TestF32FilterAlgebra's bounds, the same rejections);
6d. Config 4 of BASELINE.md, the GEO station-keeping Monte Carlo
   (examples/03_geo_analysis.py:248-350): 25 lanes, 8x8 JGM3 split,
   Sun and Moon point masses, SRP with an Earth shadow, a 0.472 N /
   4,435 s thruster under the eclipse-gated Ruggiero law, RK89 at 1e-10
   with a 30 s floor, over one day of its 30, after a 600 s warm-up, with
   its kernel launches counted and one EOM call's CUDA launches profiled;
   then 4 of its lanes over the first 4 h through the kernel and the twin
   (final positions within 1e-6 km, the same final modes);
6e. Config 1 of BASELINE.md, one spacecraft (examples/01_orbit_prop.py:
   50-93): (a) the example's scene (LEO, 21x21 JGM3 at f64, Sun and Moon,
   SRP, drag, RK89 at 1e-12) through `Propagator.rk89(...).with_state(sc,
   almanac)` and `for_duration_with_traj` with n_capture 32,768, over a cut
   depth of 3,600 s of the example's day (at B = 1 an iteration launches
   ~24,000 kernels, ~0.3-0.5 s; the hour holds the arc's first apoapsis,
   at ~1,675 s), timed, with one EOM call profiled; its f64 field runs the
   port's f64 recursion, never the kernel (the reference sends only
   float32 evaluations to Pallas), so the kernel's launch count must stay
   0; then `find_events` (one apoapsis, 1,500-1,800 s in), the parquet and
   OEM round trips, and `until_event` on a fresh instance on the card from
   the timed arc's state at 1,500 s to the arc's end, which stops within
   0.1 s of the timed arc's event and ends within 1e-6 km of its final
   position; (b) the GMAT truth on the card: a one-day two-body LEO run
   for the five adaptive tableaus (tests/test_propagators_gmat.py's
   bounds) and RK4Fixed at 10 s (the day forward and back, and the arc of
   (a) against the CPU, are held on the CPU by tests/test_torch_config1.py);
6f. Config 5 of BASELINE.md, lunar orbit determination (examples/
   04_lro_od.py:57-238): the 80x80 Kaula-rule lunar field at split
   precision (the kernel streams its table), an LRO-like 50 x 110 km polar
   orbit in MOON_J2000, RK89 at 1e-10 with a 60 s max step, over a cut
   depth of 4 h of its 24 h (two revolutions): the truth by
   `for_duration_with_traj`, timed, with one EOM call profiled by module;
   six polar IAU_MOON stations, two-way, simulated by `TrackingArcSim`; the
   segmented EKF (SNC, 3-sigma gate, stm_jvp_degree 8) over the first
   1,800 s, then over the whole arc, timed; guards: kernel launches on the
   truth and the timed arc, no twin primal call on CUDA, the final estimate
   within 100 m of the truth, range postfit RMS under 5 m; the truth's
   first 600 s through the kernel and the twin (within 1e-9 km); and
   `Trajectory.to_frame(IAU_MOON)` and `groundtrack` of the truth on the
   card against the CPU (within 1e-9);
7. print the command time and the summary.

The second-to-last line of output is the kernels' JSON summary, the last
line `{"ok": true, "device": {...}}`. In the summary `ms` is the card's
time a call, from a CUDA graph of 20 calls replayed back to back
(`ms_timing`); `eager_ms` is the time a call made back to back from the
host, as the main path makes them. Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
import warnings

_T_START = time.perf_counter()
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
B_MAIN = 10_000
B_TWIN = 64
# The reference's own f32 bound between two f32 evaluations of the
# recursion (tests/test_dynamics.py:399,415), per-lane relative norm.
KERNEL_REL_TOL = 2e-5
# Split vs full-f64 envelope over one day (tests/test_dynamics.py:304), km;
# also the OD leg's bound between its kernel and twin runs, row by row.
TWIN_FINAL_TOL_KM = 1e-3
# Config 2's twin rerun holds the kernel to the twin over this prefix of the
# day (6 h until Config 5's phase needed the time), and phase 6's 70x70
# ensemble runs over its first half hour (one hour until then).
TWIN_PREFIX_S = 2 * 3600.0
SECONDS_70X70 = 1800.0
# Config 4's station keeping (examples/03_geo_analysis.py:248-350): its 25
# lanes over one day of the 30, a NEXT-STEP-class thruster, and 4 lanes in
# the kernel-vs-twin rerun.
B_SK = 25
B_SK_TWIN = 4
SK_SECONDS = 86_400.0
# its kernel-vs-twin rerun's prefix (6 h until Config 5's phase needed the time)
SK_TWIN_PREFIX_S = 4 * 3600.0
SK_THRUST_N = 0.472
SK_ISP_S = 4435.0
# Config 4's kernel-vs-twin bound over the 6 h prefix, km. At GEO the
# kernel's share of the field (all but J2 and J3) is small: C22 alone moves
# a lane ~5.6e-3 km in 6 h (0.5 * 2.4e-11 km/s^2 * 21,600 s^2), so a kernel
# within KERNEL_REL_TOL of the twin moves it ~1e-7 km. 1e-6 km fails a
# kernel wrong by more than ~0.02 % of that share.
SK_TWIN_TOL_KM = 1e-6
# Config 1 (examples/01_orbit_prop.py): the example's day cut to its first
# hour, and the window its one apoapsis (~1,675 s) must fall in, whose start
# is where `until_event`'s fresh instance starts.
EX01_SECONDS = 3600.0
EX01_APOAPSIS_S = (1500.0, 1800.0)
# GMAT's one-day two-body LEO truth (tests/test_propagators_gmat.py:19-45,
# the reference's propagators.rs:36-145), at GMAT's Earth GM, and the
# bounds of tests/test_propagators_gmat.py:67, km and km/s.
GMAT_Y0 = (-2436.45, -2436.45, 6891.037, 5.088_611, -5.088_611, 0.0)
GMAT_TRUTH = {
    "Dormand45": (-5_971.194_191_972_314, 3_945.506_662_039_457, 2_864.636_606_375_225_7,
                  0.049_096_946_846_257_56, -4.185_093_311_278_763, 5.848_940_872_821_106),
    "Verner56": (-5_971.194_191_678_94, 3_945.506_653_872_037_5, 2_864.636_617_510_367,
                 0.049_096_956_828_408_46, -4.185_093_317_946_663, 5.848_940_868_134_195_4),
    "Dormand78": (-5_971.194_191_670_392, 3_945.506_653_218_658, 2_864.636_618_422_25,
                  0.049_096_957_637_897_856, -4.185_093_318_481_106, 5.848_940_867_745_3),
    "RK89": (-5_971.194_191_670_676, 3_945.506_653_225_158, 2_864.636_618_413_444_5,
             0.049_096_957_629_993_46, -4.185_093_318_475_795, 5.848_940_867_748_944),
    "CashKarp45": (-5_971.194_190_197_366, 3_945.506_606_221_459_6, 2_864.636_682_800_498_4,
                   0.049_097_015_227_526_38, -4.185_093_356_859_808, 5.848_940_840_578_1),
}
GMAT_TOL = {"Dormand45": 1e-7, "CashKarp45": 1e-5}  # 1e-8 for the others
# Radii of the kernel-vs-twin positions: the main path's LEO, GEO with
# Config 4's 3 km sma spread and its ecc objective, and Config 5's lunar
# orbit (its perilune and apolune).
LEO_RADII_KM = (6_700.0, 7_500.0)
GEO_RADII_KM = (42_100.0, 42_230.0)
LUNAR_RADII_KM = (1_787.4, 1_847.4)
# Config 5's stage 2 runs one RK89 step of the [M, 90] STM EOM a segment,
# M <= segment_rows = 32 rows; its 9 forward-mode passes fold into the
# batch, so the kernel's primal sees B = 9 M lanes.
B_EX04_STM = 9 * 32
# The bench's OD guard: final position error against the truth (bench.py:376).
OD_GUARD_KM = 0.1
# Config 5 (examples/04_lro_od.py): the lunar GM of the field and the orbit's
# frame, the example's 24 h arc cut to 4 h (two revolutions of the 1.93 h
# orbit; 6 h took phase 6f 225 s on an NVIDIA H100 80GB HBM3 at 700 W), the
# range postfit RMS guard, km, and the twin witness's prefix.
EX04_MU = 4902.800066
EX04_HOURS = 4.0
EX04_POSTFIT_RMS_KM = 5e-3
EX04_TWIN_PREFIX_S = 600.0
# f32 against f64 filter algebra (tests/test_od.py:1782-1792): positions
# (km) and sigmas (relative).
OD_F32_POS_KM = 2e-3
OD_F32_SIGMA_REL = 0.05
# The card's peaks (NVIDIA H100 SXM data sheet): 67 TFLOP/s of f32 counts a
# fused multiply-add as two operations; the kernel is built without
# contraction, so each of its operations is one instruction at half that.
F32_OPS_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _body_fixed(n: int, seed: int, radii_km=LEO_RADII_KM) -> np.ndarray:
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3))
    return r / np.linalg.norm(r, axis=1, keepdims=True) * rng.uniform(*radii_km, (n, 1))


def _time_ms(fn, calls: int = 20, window_ms: float = 200.0) -> float:
    """The card's mean ms per call: `calls` calls captured in one CUDA graph,
    replayed back to back over a window of about `window_ms`, timed with
    CUDA events. Replaying the graph takes the host's launch cost out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 2
    for _ in range(2):  # warm up, then size the window from the warm-up's rate
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        reps = max(2, min(10_000, int(window_ms * reps / start.elapsed_time(end))))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def _eager_ms(fn, window_ms: float = 200.0) -> float:
    """Mean ms per call of back-to-back calls from the host, as the main
    path makes them: the larger of the card's time and the host's."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < window_ms / 1e3:
        fn()
        n += 1
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def pines_ops_per_lane(n_steps: int, W: int, q_lo: int) -> int:
    """f32 operations one lane needs, counted from the recursion: at degree
    step k only orders m <= k+2 are nonzero; each takes 7 operations for its
    Legendre row and, where the degree accumulates, 25 for d, e, f and the
    four sums; then the powers (6 a column), the order sums (4 a column),
    the prelude and the final combination (~20)."""
    cols = [min(k + 3, W) for k in range(n_steps)]
    accumulated = sum(c for k, c in enumerate(cols) if k + 1 > q_lo)
    return 7 * sum(cols) + 25 * accumulated + 10 * (W - 1) + 20


def pines_bound_ms(B: int, n_steps: int, W: int, W_pad: int, q_lo: int) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations over
    the f32 rate and the bytes (positions in, accelerations out, the table
    once) over the memory rate."""
    ops_s = B * pines_ops_per_lane(n_steps, W, q_lo) / F32_OPS_PER_S
    bytes_s = (24 * B + 4 * n_steps * 8 * W_pad) / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def extend_kaula(stor, degree: int, seed: int):
    """`stor` (a GravityFieldData) extended to a `degree` x `degree` field:
    its own coefficients up to its degree and order, and above its degree
    random fully normalized C/S of Kaula-rule magnitude (standard deviation
    1e-5 / n^2) from `np.random.default_rng(seed)`. A synthetic field with a
    realistic spectrum for the kernel's high-degree paths; it models no
    body."""
    rng = np.random.default_rng(seed)
    c_nm = np.zeros((degree + 1, degree + 1))
    s_nm = np.zeros((degree + 1, degree + 1))
    n0, m0 = stor.c_nm.shape
    c_nm[:n0, :m0] = stor.c_nm
    s_nm[:n0, :m0] = stor.s_nm
    for n in range(n0, degree + 1):
        sigma = 1e-5 / n**2
        c_nm[n, : n + 1] = rng.normal(0.0, sigma, n + 1)
        s_nm[n, 1 : n + 1] = rng.normal(0.0, sigma, n)
    return dataclasses.replace(stor, c_nm=c_nm, s_nm=s_nm)


def kaula_moon_field(n_max: int = 80, seed: int = 7):
    """examples/04_lro_od.py:61-79 as numpy, into the port's
    GravityFieldData: a synthetic lunar field with fully normalized C/S of
    Kaula-rule magnitude (standard deviation 3.5e-4 / n^2) from
    `np.random.default_rng(seed)`, drawn degree by degree, C before S at
    each order, the real lunar J2 (C20 = -9.08e-5), GM 4,902.800066 km^3/s^2,
    radius 1,737.4 km, in IAU_MOON."""
    from nyx_tpu_torch import Frames
    from nyx_tpu_torch.io.gravity import GravityFieldData

    rng = np.random.default_rng(seed)
    c = np.zeros((n_max + 1, n_max + 1))
    s = np.zeros((n_max + 1, n_max + 1))
    c[0, 0] = 1.0
    for n in range(2, n_max + 1):
        sigma = 3.5e-4 / n**2
        for m in range(0, n + 1):
            c[n, m] = rng.normal(0, sigma)
            if m > 0:
                s[n, m] = rng.normal(0, sigma)
    c[2, 0] = -9.08e-5
    return GravityFieldData(c_nm=c, s_nm=s, mu_km3_s2=EX04_MU, radius_km=1737.4, frame=Frames.IAU_MOON)


def ex04_scene(stor, precision: str = "split", *, device="cuda"):
    """The scene of examples/04_lro_od.py:81-238 through the port's own
    names, on the field `stor` (`kaula_moon_field`): the LRO-like polar
    orbit (apsis radii 1,847.4 / 1,787.4 km, i 89.7 deg, RAAN 270 deg) in
    MOON_J2000 at the example's GM, RK89 at a 60 s max step and 1e-10, the
    six polar stations (IAU_MOON, two-way with a 60 s integration time, 5
    deg mask, range 2 m and Doppler 3 mm/s white noise), TrkConfig(60 s,
    min_samples=3), the RIC uncertainty with one draw from
    `np.random.default_rng(42)`, and the filter factory (segmented EKF,
    SNC 1e-16 km^2/s^4 for 3,600 s, 3-sigma gate, stm_jvp_degree 8).
    Returns a namespace of them; `propagator(backend)` and `od(backend)`
    build the propagator and the filter with that gravity backend."""
    from types import SimpleNamespace

    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft
    from nyx_tpu_torch.dynamics import Harmonics, OrbitalDynamics, SpacecraftDynamics
    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.od import (
        GroundStation, MeasurementType, ProcessNoise, ScanKalmanOD, Scheduler, SpacecraftUncertainty,
        StochasticNoise, TrkConfig, WhiteNoise,
    )
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    epoch = Epoch.from_gregorian_utc(2024, 1, 1, 0, 0, 0)
    moon_j2000 = Frames.MOON_J2000
    orbit = Orbit.keplerian_apsis_radii(1737.4 + 110.0, 1737.4 + 50.0, 89.7, 270.0, 30.0, 0.0, epoch,
                                        moon_j2000.with_mu_km3_s2(EX04_MU))
    truth = Spacecraft.from_orbit(orbit)

    def propagator(backend):
        dyn = SpacecraftDynamics.new(OrbitalDynamics.from_model(
            Harmonics.from_stor(stor, precision=precision, backend=backend), moon_j2000))
        return Propagator.rk89(dyn, IntegratorOptions(max_step_s=60.0, tolerance=1e-10))

    def station(name, lat, lon):
        gs = GroundStation(name, lat, lon, 0.0, frame=Frames.IAU_MOON, elevation_mask_deg=5.0,
                           integration_time_s=60.0)
        gs.stochastic_noises = {MeasurementType.RANGE_KM: StochasticNoise(WhiteNoise(2.0e-3)),
                                MeasurementType.DOPPLER_KM_S: StochasticNoise(WhiteNoise(3.0e-6))}
        return gs

    stations = [station("Shackleton", -89.5, 0.0), station("Malapert", -86.0, 2.9),
                station("Peary", 88.6, 33.0), station("Amundsen", -84.5, 69.9),
                station("Whipple", 89.1, 120.0), station("Cabeus", -85.3, -42.1)]
    cfg = TrkConfig(sampling_s=60.0, scheduler=Scheduler(min_samples=3))
    almanac = Almanac()
    est0 = SpacecraftUncertainty(nominal=truth, frame="ric", x_km=0.1, y_km=0.1, z_km=0.1,
                                 vx_km_s=1e-5, vy_km_s=1e-5, vz_km_s=1e-5).to_estimate()
    draw = np.random.default_rng(42).multivariate_normal(np.zeros(9), est0.covar)
    est0.nominal = truth.set_vector(epoch, truth.to_vector() + draw)

    def od(backend):
        return ScanKalmanOD(propagator(backend), stations,
                            types=(MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S),
                            variant="ekf", process_noise=(ProcessNoise.from_diag([1e-16] * 3, 3600.0),),
                            resid_rejection_sigmas=3.0, almanac=almanac, stm_jvp_degree=8,
                            device=device)

    return SimpleNamespace(truth=truth, propagator=propagator, stations=stations, cfg=cfg,
                           almanac=almanac, est0=est0, od=od)


def _parent_gravity(root: Path):
    """The `gravity_pines` module of the port in the checkout at `root`,
    imported under another package name beside this one: its own wrapper,
    its own kernel source and its own build directory."""
    name = "parent_nyx_tpu_torch"
    pkg = root / "nyx_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.dynamics.gravity_pines")


def phase_kernel_vs_twin(gp, fields, parent):
    """Kernel vs twin on the card in every case, then the kernel's times at
    B = 10,000 beside their bounds. Returns the summary's numbers."""
    max_rel = max_abs = 0.0
    leo = ((B_MAIN, 37, 1), LEO_RADII_KM)
    cases = [("21x21", 0, leo), ("21x21", 3, leo), ("12x6", 0, leo), ("70x70", 0, leo),
             ("70x70", 3, leo), ("120x120", 3, leo), ("160x160", 3, leo),
             # phase 6d's field, batches and radii, at the q_lo its split field passes
             ("8x8", 0, ((B_SK, B_SK_TWIN), GEO_RADII_KM)),
             # phase 6f's field at lunar radii: the truth's and stage 1's single
             # lane, stage 2's [M, 90] STM batch and the main path's B
             ("moon80x80", 3, ((1, B_EX04_STM, B_MAIN), LUNAR_RADII_KM))]
    for name, q_lo, (batches, radii) in cases:
        h = fields[name]
        tab = h.packed_table(0, torch.float32, "cuda")
        kw = h.pines_args()
        plan = gp.pines_launch_plan(tab.shape[0], tab.shape[2])
        for B in batches:
            r = torch.tensor(_body_fixed(B, 1000 + B, radii), dtype=torch.float32, device="cuda")
            a_k = gp.pines_accel_cuda(r, tab, q_lo, **kw)
            a_t = gp.pines_accel_torch(r, tab, q_lo, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(a_k).all():
                raise RuntimeError(f"kernel returned non-finite values ({name}, B={B})")
            rel = ((a_k - a_t).norm(dim=1) / a_t.norm(dim=1)).max().item()
            abs_err = (a_k - a_t).abs().max().item()
            n_diff = int((a_k != a_t).sum())
            _log(f"kernel vs twin {name} {h.precision} q_lo={q_lo} B={B} "
                 f"({'whole table' if plan.whole else f'streamed, {plan.chunk_steps} steps a buffer'}, "
                 f"{plan.smem_bytes} B shared): max rel {rel:.3e}, "
                 f"max abs {abs_err:.3e} km/s^2, {n_diff} of {a_k.numel()} values differ in any bit")
            if not rel < KERNEL_REL_TOL:
                raise RuntimeError(f"kernel disagrees with twin: rel {rel} >= {KERNEL_REL_TOL}")
            max_rel, max_abs = max(max_rel, rel), max(max_abs, abs_err)

    r = torch.tensor(_body_fixed(B_MAIN, 1000 + B_MAIN), dtype=torch.float32, device="cuda")
    out = {}
    for name in ("21x21", "70x70", "120x120"):
        h = fields[name]
        tab = h.packed_table(0, torch.float32, "cuda")
        kw = h.pines_args()
        ms = _time_ms(lambda: gp.pines_accel_cuda(r, tab, 0, **kw))
        bound, bound_by = pines_bound_ms(B_MAIN, tab.shape[0], kw["W"], tab.shape[2], 0)
        _log(f"{name} split q_lo=0 at B={B_MAIN}: kernel {ms:.4f} ms per call, bound {bound:.4f} ms "
             f"({bound_by}; {pines_ops_per_lane(tab.shape[0], kw['W'], 0)} operations a lane), "
             f"{100 * bound / ms:.1f} % of bound")
        out[name] = (ms, bound, bound_by)
    h = fields["moon80x80"]
    tab = h.packed_table(0, torch.float32, "cuda")
    kw = h.pines_args()
    for B in (1, B_EX04_STM):
        r_moon = torch.tensor(_body_fixed(B, 2000 + B, LUNAR_RADII_KM), dtype=torch.float32, device="cuda")
        ms = _time_ms(lambda: gp.pines_accel_cuda(r_moon, tab, 3, **kw))
        bound, bound_by = pines_bound_ms(B, tab.shape[0], kw["W"], tab.shape[2], 3)
        _log(f"moon80x80 split q_lo=3 at B={B}: kernel {ms:.4f} ms per call, bound {bound:.6f} ms "
             f"({bound_by}), {100 * bound / ms:.2f} % of bound")
        out[f"moon80x80_b{B}"] = (ms, bound, bound_by)
    h = fields["21x21"]
    tab = h.packed_table(0, torch.float32, "cuda")
    kw = h.pines_args()
    eager_ms = _eager_ms(lambda: gp.pines_accel_cuda(r, tab, 0, **kw))
    twin_ms = _time_ms(lambda: gp.pines_accel_torch(r, tab, 0, **kw), calls=2)
    twin_eager_ms = _eager_ms(lambda: gp.pines_accel_torch(r, tab, 0, **kw))
    _log(f"21x21 split q_lo=0 at B={B_MAIN}: kernel {eager_ms:.4f} ms per call back to back from "
         f"the host; twin {twin_ms:.4f} ms on the card, {twin_eager_ms:.4f} ms from the host")
    parent_ms = parent_eager_ms = None
    if parent is not None:
        a_p = parent.pines_accel_cuda(r, tab, 0, **kw)
        n_diff = int((a_p != gp.pines_accel_torch(r, tab, 0, **kw)).sum())
        calls = {"parent": lambda: parent.pines_accel_cuda(r, tab, 0, **kw),
                 "kernel": lambda: gp.pines_accel_cuda(r, tab, 0, **kw)}
        turns = ("parent", "kernel", "kernel", "parent")
        parent_means = []
        for label, timer in (("on the card", _time_ms), ("from the host", _eager_ms)):
            times = [timer(calls[who]) for who in turns]
            _log(f"21x21 split q_lo=0 at B={B_MAIN}, ms a call {label}, in turns: "
                 + ", ".join(f"{who} {ms:.4f}" for who, ms in zip(turns, times))
                 + f" (parent vs twin: {n_diff} values differ in any bit)")
            parent_means.append((times[0] + times[3]) / 2)
        parent_ms, parent_eager_ms = parent_means
    return dict(max_rel=max_rel, max_abs=max_abs, times=out, twin_ms=twin_ms, parent_ms=parent_ms,
                eager_ms=eager_ms, twin_eager_ms=twin_eager_ms, parent_eager_ms=parent_eager_ms)


def run_and_rerun(mc_seed, mvn, propagator, alm, start, seconds, gp, label):
    """A B_MAIN-lane ensemble through the kernel, with its launches counted
    from 0, then B_TWIN of its lanes through the gravity twin over the arc's
    first min(seconds, TWIN_PREFIX_S), held against the ensemble's finals
    where that is the whole arc, else against a fresh B_TWIN-lane kernel
    run of the prefix. Returns the launches."""
    from nyx_tpu_torch.mc import MonteCarlo

    end = start + seconds
    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = MonteCarlo(mvn, seed=mc_seed).run_until_epoch(propagator("auto"), alm, end, B_MAIN, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gp.pines_accel_cuda.launches
    twin_cuda_calls = gp.pines_accel_torch.cuda_calls
    _log(f"{label}: B={B_MAIN}, {seconds} s arc, wall {wall:.3f} s, "
         f"{res.n_ok / wall:.2f} traj/s, mean accepted steps {float(np.mean(res.n_accepted)):.2f}, "
         f"mean rejected {float(np.mean(res.n_rejected)):.2f}, iterations {res.iterations}, "
         f"n_ok/n_runs {res.n_ok}/{res.n_runs}, kernel launches {launches}, "
         f"twin CUDA calls {twin_cuda_calls}")
    if res.n_ok != res.n_runs:
        raise RuntimeError(f"{label}: {res.n_ok}/{res.n_runs} lanes ok")
    if res.y_final.shape != (B_MAIN, 9) or not np.isfinite(res.y_final).all():
        raise RuntimeError(f"{label}: final states are not finite [B, 9]")
    if launches <= 0 or twin_cuda_calls != 0:
        raise RuntimeError(
            f"{label} did not run through the kernel: {launches} launches, "
            f"{twin_cuda_calls} twin calls on CUDA"
        )

    y0 = res.y_initial[:B_TWIN]
    twin_seconds = min(seconds, TWIN_PREFIX_S)
    kernel = res if twin_seconds == seconds else MonteCarlo(mvn, seed=mc_seed).run_until_epoch(
        propagator("auto"), alm, start + twin_seconds, B_TWIN, device="cuda", _y0=y0)
    t0 = time.perf_counter()
    twin = MonteCarlo(mvn, seed=mc_seed).run_until_epoch(
        propagator("torch"), alm, start + twin_seconds, B_TWIN, device="cuda", _y0=y0
    )
    if twin.n_ok != B_TWIN:
        raise RuntimeError(f"{label} twin rerun: {twin.n_ok}/{B_TWIN} lanes ok")
    d_km = np.linalg.norm(twin.y_final[:, :3] - kernel.y_final[:B_TWIN, :3], axis=1).max()
    _log(f"{label} twin rerun of {B_TWIN} lanes over {twin_seconds} s ({time.perf_counter() - t0:.1f} s): "
         f"max final position difference {d_km:.3e} km from the kernel's, mean accepted steps "
         f"{float(np.mean(twin.n_accepted)):.2f} vs {float(np.mean(kernel.n_accepted[:B_TWIN])):.2f}")
    if not d_km < TWIN_FINAL_TOL_KM:
        raise RuntimeError(f"{label}: kernel and twin runs differ by {d_km} km >= {TWIN_FINAL_TOL_KM}")
    return launches


def _head(arc, seconds: float):
    """The rows of `arc` in its first `seconds`."""
    from nyx_tpu_torch.od import TrackingDataArc

    keep = arc.epochs_tai_s < arc.epochs_tai_s[0] + seconds
    return TrackingDataArc(arc.trackers, arc.types, arc.epochs_tai_s[keep], arc.tracker_idx[keep],
                           arc.values[keep])


def _dsn_stations(integration_time_s=None):
    """DSS-65, DSS-34 and DSS-13 at a 10 deg mask with the bench's white
    noise (range 2 m, Doppler 3 mm/s), two-way when given a time."""
    from nyx_tpu_torch.od import GroundStation, MeasurementType, StochasticNoise, WhiteNoise

    stations = [GroundStation.dss65_madrid(10.0), GroundStation.dss34_canberra(10.0),
                GroundStation.dss13_goldstone(10.0)]
    for gs in stations:
        gs.stochastic_noises = {MeasurementType.RANGE_KM: StochasticNoise(WhiteNoise(2.0e-3)),
                                MeasurementType.DOPPLER_KM_S: StochasticNoise(WhiteNoise(3.0e-6))}
        gs.integration_time_s = integration_time_s
    return stations


def _od_propagator(stor21, backend):
    from nyx_tpu_torch import Frames
    from nyx_tpu_torch.dynamics import Harmonics, OrbitalDynamics, SpacecraftDynamics
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    field = Harmonics.from_stor(stor21, precision="split", backend=backend)
    dyn = SpacecraftDynamics(OrbitalDynamics.from_model(field, Frames.EME2000), ())
    return Propagator.rk89(dyn, IntegratorOptions())


def _f32_vs_f64(label, sol, sol64):
    """Hold an f32-algebra solution to the f64 one (TestF32FilterAlgebra's
    bounds, the same rejections); a rejection that differs is printed
    with its ratio in both runs."""
    d_pos = float(np.linalg.norm(sol64.y_est[:, :3] - sol.y_est[:, :3], axis=1).max())
    s32, s64 = (np.sqrt(np.diagonal(s.covar, axis1=1, axis2=2)[:, :6]) for s in (sol, sol64))
    d_sig = float((np.abs(s32 - s64) / s64).max())
    same_rej = bool(np.array_equal(sol.rejected, sol64.rejected))
    _log(f"{label} f32 vs f64 algebra: max position difference {d_pos:.3e} km, max sigma "
         f"difference {d_sig:.3e}, rejections identical: {same_rej}")
    for i in np.flatnonzero(sol.rejected != sol64.rejected):
        _log(f"{label} row {i}: rejected {bool(sol.rejected[i])} at ratio {sol.ratio[i]:.6f} (f32), "
             f"{bool(sol64.rejected[i])} at ratio {sol64.ratio[i]:.6f} (f64)")
    if not (d_pos < OD_F32_POS_KM and d_sig < OD_F32_SIGMA_REL and same_rej):
        raise RuntimeError(f"{label} f32 algebra outside TestF32FilterAlgebra's bounds")


def phase_od(gp, stor21):
    """The bench's OD leg through the port on the card (bench.py:295-403).
    Returns the summary's numbers, and the truth for phase 6c."""
    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft
    from nyx_tpu_torch.od import (
        MeasurementType, ScanKalmanOD, Scheduler, SpacecraftUncertainty, TrackingArcSim, TrkConfig,
    )

    types = (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S)
    epoch = Epoch.from_gregorian_utc(2021, 3, 4)
    orbit = Orbit.keplerian(22_000.0, 0.01, 30.0, 80.0, 40.0, 0.0, epoch, Frames.EME2000)
    truth = Spacecraft.from_orbit(orbit)

    gp.pines_accel_cuda.launches = 0
    t0 = time.perf_counter()
    _, traj = _od_propagator(stor21, "auto").with_state(truth).for_duration_with_traj(86_400.0)
    truth_s, truth_launches = time.perf_counter() - t0, gp.pines_accel_cuda.launches

    stations = _dsn_stations()
    cfg = TrkConfig(sampling_s=60.0, scheduler=Scheduler(min_samples=5))
    t0 = time.perf_counter()
    arc = TrackingArcSim.with_seed(stations, traj, {g.name: cfg for g in stations},
                                   seed=0).generate_measurements()
    sim_s = time.perf_counter() - t0
    _log(f"OD truth: one day, {len(traj)} nodes, {truth_s:.3f} s, {truth_launches} kernel launches; "
         f"simulated {len(arc)} rows from {len(arc.trackers)} stations in {sim_s:.3f} s")
    est0 = SpacecraftUncertainty(nominal=truth, frame="ric", x_km=0.15, y_km=0.15, z_km=0.15,
                                 vx_km_s=5e-6, vy_km_s=5e-6, vz_km_s=5e-6).to_estimate()

    def od(backend, algebra):
        return ScanKalmanOD(_od_propagator(stor21, backend), stations, types=types, variant="ckf",
                            stm_jvp_degree=8, filter_algebra=algebra)

    warm_arc = _head(arc, 7200.0)
    scan = od("auto", "f32")
    # the warm-up also counts the host synchronizations that torch flags
    # (a per-row sync in the filter loop would show as one a row)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            warm = scan.process_arc(est0, warm_arc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    _log(f"OD warm-up, first 2 h ({len(warm_arc)} rows): {syncs} synchronizing calls flagged "
         f"by torch.cuda.set_sync_debug_mode")

    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    gp.pines_tangent_torch.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = scan.process_arc(est0, arc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gp.pines_accel_cuda.launches
    twin_calls, tangent_calls = gp.pines_accel_torch.cuda_calls, gp.pines_tangent_torch.cuda_calls
    rate = len(arc) / wall
    truth_fin = traj.at(Epoch.from_tai_seconds_j2000(float(sol.epochs_tai_s[-1]))).to_vector()
    err_km = float(np.linalg.norm(sol.final_state()[:3] - truth_fin[:3]))
    walls = ", ".join(f"{k} {scan.stage_walls_s[k]:.3f} s" for k in ("s1", "s2", "s3", "s4"))
    _log(f"OD filter ({_card_line()}): M = {len(arc)} rows, wall {wall:.3f} s, {rate:.2f} rows/s; "
         f"stages {walls}; max_gap_s {scan.max_gap_s:.1f}, capture {scan._last_k_cap} nodes; "
         f"kernel launches {launches}, twin primal calls on CUDA {twin_calls}, "
         f"twin tangent calls {tangent_calls}; rejected {int(sol.rejected.sum())}; "
         f"final position error vs truth {err_km * 1e3:.3f} m")
    if sol.y_est.shape != (len(arc), 9) or not np.isfinite(sol.y_est).all():
        raise RuntimeError("OD filter: estimates are not finite [M, 9]")
    if launches <= 0 or twin_calls != 0:
        raise RuntimeError(f"OD filter did not run through the kernel: {launches} launches, "
                           f"{twin_calls} twin primal calls on CUDA")
    if not err_km < OD_GUARD_KM:
        raise RuntimeError(f"OD filter diverged: {err_km * 1e3:.1f} m final error")

    # the twin and f64 reruns take the warm-up's arc and are held to the
    # warm-up: a whole day through the twin pays its gravity at B = 1 in
    # every stage-1 step
    twin = od("torch", "f32").process_arc(est0, warm_arc)
    d_twin = float(np.linalg.norm(twin.y_est[:, :3] - warm.y_est[:, :3], axis=1).max())
    _log(f"OD twin rerun of the first 2 h ({len(warm_arc)} rows): max row position difference "
         f"{d_twin:.3e} km")
    if not d_twin < TWIN_FINAL_TOL_KM:
        raise RuntimeError(f"OD kernel and twin runs differ by {d_twin} km")

    _f32_vs_f64("OD, first 2 h,", warm, od("auto", "f64").process_arc(est0, warm_arc))
    return dict(launches=launches, rows_per_s=rate, rows=len(arc), wall=wall, truth=truth,
                traj=traj)


def phase_od_flagship(gp, stor21, truth, traj):
    """The bench's flagship OD leg through the port on the card
    (bench.py:407-434) on phase 6b's truth. Returns the summary's numbers."""
    from nyx_tpu_torch import Epoch
    from nyx_tpu_torch.od import (
        MeasurementType, ProcessNoise, ScanKalmanOD, Scheduler, SpacecraftUncertainty,
        TrackingArcSim, TrkConfig,
    )

    t_phase = time.perf_counter()
    types = (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S)
    stations = _dsn_stations(integration_time_s=60.0)
    cfg = TrkConfig(sampling_s=60.0, scheduler=Scheduler(min_samples=5))
    t0 = time.perf_counter()
    arc = TrackingArcSim.with_seed(stations, traj, {g.name: cfg for g in stations},
                                   seed=0).generate_measurements()
    _log(f"OD flagship: simulated {len(arc)} two-way rows from {len(arc.trackers)} stations in "
         f"{time.perf_counter() - t0:.3f} s")
    est = SpacecraftUncertainty(nominal=truth, frame="ric", x_km=0.15, y_km=0.15, z_km=0.15,
                                vx_km_s=5e-6, vy_km_s=5e-6, vz_km_s=5e-6).to_estimate()
    draw = np.random.default_rng(7).multivariate_normal(np.zeros(9), est.covar)
    est.nominal = truth.set_vector(truth.epoch, truth.to_vector() + draw)

    def od(backend, algebra):
        return ScanKalmanOD(_od_propagator(stor21, backend), stations, types=types, variant="ekf",
                            process_noise=(ProcessNoise.from_diag([1e-16] * 3, 3600.0),),
                            resid_rejection_sigmas=3.0, stm_jvp_degree=8, filter_algebra=algebra)

    scan = od("auto", "f32")
    warm_arc = _head(arc, 7200.0)
    warm = scan.process_arc(est, warm_arc)  # warm-up; the reruns below are held to it

    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    gp.pines_tangent_torch.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = scan.process_arc(est, arc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gp.pines_accel_cuda.launches
    twin_calls, tangent_calls = gp.pines_accel_torch.cuda_calls, gp.pines_tangent_torch.cuda_calls
    w = scan.stage_walls_s
    rate = len(arc) / wall
    truth_fin = traj.at(Epoch.from_tai_seconds_j2000(float(sol.epochs_tai_s[-1]))).to_vector()
    err_km = float(np.linalg.norm(sol.final_state()[:3] - truth_fin[:3]))
    _log(f"OD flagship filter ({_card_line()}), EKF, f32 algebra, timed process_arc:")
    _log(f"  rows {len(arc)}")
    _log(f"  segments {w['segments']} (capture {scan._last_k_cap} nodes, max_gap_s {scan.max_gap_s:.1f})")
    _log(f"  wall {wall:.3f} s, {rate:.2f} rows/s")
    _log("  stage walls summed over the segments: "
         + ", ".join(f"{k} {w[k]:.3f} s" for k in ("s1", "s2", "s3", "s4")))
    _log(f"  s1 integrator iterations {w['s1_iterations']}")
    _log(f"  rejected {int(sol.rejected.sum())}")
    _log(f"  kernel launches {launches}, twin primal calls on CUDA {twin_calls}, "
         f"twin tangent calls {tangent_calls}")
    _log(f"  final position error vs truth {err_km * 1e3:.3f} m")
    if sol.y_est.shape != (len(arc), 9) or not np.isfinite(sol.y_est).all():
        raise RuntimeError("OD flagship: estimates are not finite [M, 9]")
    if launches <= 0 or twin_calls != 0:
        raise RuntimeError(f"OD flagship did not run through the kernel: {launches} launches, "
                           f"{twin_calls} twin primal calls on CUDA")
    if not err_km < OD_GUARD_KM:
        raise RuntimeError(f"OD flagship filter diverged: {err_km * 1e3:.1f} m final error")

    # the twin and f64 reruns take the warm-up's arc, as in phase 6b
    twin = od("torch", "f32").process_arc(est, warm_arc)
    d_twin = float(np.linalg.norm(twin.y_est[:, :3] - warm.y_est[:, :3], axis=1).max())
    _log(f"OD flagship twin rerun of the first 2 h ({len(warm_arc)} rows): max row position "
         f"difference {d_twin:.3e} km")
    if not d_twin < TWIN_FINAL_TOL_KM:
        raise RuntimeError(f"OD flagship kernel and twin runs differ by {d_twin} km")
    _f32_vs_f64("OD flagship, first 2 h,", warm, od("auto", "f64").process_arc(est, warm_arc))
    _log(f"OD flagship phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, rows_per_s=rate, rows=len(arc), wall=wall)


def _sk_scene(stor8):
    """Config 4's station keeping (examples/03_geo_analysis.py:255-306)
    through the port: the template, and a factory of propagators by
    gravity backend."""
    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft
    from nyx_tpu_torch.constants import NAIF
    from nyx_tpu_torch.cosmic.spacecraft import GuidanceMode, Thruster
    from nyx_tpu_torch.dynamics import (
        Harmonics, OrbitalDynamics, PointMasses, Ruggiero, SolarPressure, SpacecraftDynamics,
    )
    from nyx_tpu_torch.md.objective import Objective
    from nyx_tpu_torch.md.param import StateParameter
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    epoch = Epoch.from_gregorian_utc(2024, 2, 29, 12, 13, 14)
    orbit = Orbit.keplerian(42_164.0, 1e-5, 0.0, 163.0, 75.0, 0.0, epoch, Frames.EME2000)
    sc = Spacecraft.from_thruster(orbit, dry_mass_kg=1000.0, prop_mass_kg=1000.0,
                                  thruster=Thruster(thrust_N=SK_THRUST_N, isp_s=SK_ISP_S),
                                  mode=GuidanceMode.Thrust).with_srp(3.0 * 6.0, 1.8)
    objectives = [
        Objective.within_tolerance(StateParameter.SMA, 42_165.0, 20.0),
        Objective.within_tolerance(StateParameter.ECC, 0.001, 5e-5),
        Objective.within_tolerance(StateParameter.INC, 0.05, 1e-2),
    ]
    # thrust is inhibited whenever the occultation exceeds 20 % of the disk
    law = Ruggiero.from_max_eclipse(objectives, sc, 0.2)

    def propagator(backend):
        field = Harmonics.from_stor(stor8, precision="split", backend=backend)
        dyn = SpacecraftDynamics(
            OrbitalDynamics.from_models((field, PointMasses((NAIF.MOON, NAIF.SUN))), Frames.EME2000),
            (SolarPressure.default(),),
            guidance=law,
        )
        return Propagator.rk89(dyn, IntegratorOptions(min_step_s=30.0, tolerance=1e-10))

    return sc, propagator


def _kernel_count(fn):
    """CUDA kernels one call of `fn` launches, from torch.profiler: (device-
    side kernel events, the host's kernel-launch calls, top-level aten ops)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # the first call fills caches (the field's table, say)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in events)
    host = sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx") for e in events)
    ops = sum(e.name.startswith("aten::") and e.cpu_parent is None for e in events)
    return kernels, host, ops


def _eom_launch_count(prop, sc, alm, y0):
    """CUDA kernels one call of `prop`'s EOM (guided or not) launches on the
    [B, N] states `y0` (numpy), from torch.profiler (device-side kernel
    events, the host's kernel-launch calls, and the top-level aten ops)."""
    y = torch.as_tensor(y0, device="cuda")
    dyn = prop.dynamics
    ctx = dyn.build_context(sc.epoch, 600.0, alm, device="cuda")
    eom = dyn.make_eom(thruster=sc.thruster)
    p = dict(dry_mass_kg=sc.dry_mass_kg, srp_area_m2=sc.srp_area_m2, drag_area_m2=sc.drag_area_m2)
    t = torch.zeros(y.shape[0], dtype=torch.float64, device="cuda")
    return _kernel_count(lambda: eom(t, y, ctx, p))


def phase_geo_sk(gp, stor8):
    """Config 4's station-keeping Monte Carlo on the card: 25 lanes over one
    day of its 30, after a 600 s warm-up, then 4 of its lanes over the
    first 6 h through the kernel and through the twin. Returns the
    summary's numbers."""
    from nyx_tpu_torch.constants import STD_GRAVITY_M_S2
    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.mc import MonteCarlo, MvnSpacecraft, StateDispersion

    t_phase = time.perf_counter()
    sc, propagator = _sk_scene(stor8)
    prop = propagator("auto")
    mvn = MvnSpacecraft(sc, [StateDispersion.zero_mean("sma", 3.0)])
    alm = Almanac()
    warm = MonteCarlo(mvn, seed=3).run_until_epoch(prop, alm, sc.epoch + 600.0, B_SK, device="cuda")
    if warm.n_ok != B_SK:
        raise RuntimeError(f"station keeping warm-up: {warm.n_ok}/{B_SK} lanes ok")
    _log(f"station keeping warm-up, 600 s: {time.perf_counter() - t_phase:.1f} s")
    kernels, host_launches, ops = _eom_launch_count(prop, sc, alm, warm.y_initial)
    _log(f"station keeping EOM, one call at B={B_SK} (torch.profiler): {kernels} CUDA kernels on the "
         f"device, {host_launches} kernel-launch calls from the host, {ops} top-level aten ops")

    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = MonteCarlo(mvn, seed=3).run_until_epoch(prop, alm, sc.epoch + SK_SECONDS, B_SK, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, twin_calls = gp.pines_accel_cuda.launches, gp.pines_accel_torch.cuda_calls
    used = sc.prop_mass_kg - res.y_final[:, 8]
    days = SK_SECONDS / 86_400.0
    _log(f"station keeping ({_card_line()}), Config 4, {B_SK} lanes x {days:g} day:")
    _log(f"  wall {wall:.3f} s, {res.n_ok / wall:.4f} traj/s, "
         f"{res.n_ok * days / (wall / 60.0):.3f} lane-days per minute")
    _log(f"  n_ok/n_runs {res.n_ok}/{res.n_runs}")
    _log(f"  mean accepted steps {float(np.mean(res.n_accepted)):.2f}, mean rejected "
         f"{float(np.mean(res.n_rejected)):.2f}, integrator iterations {res.iterations}")
    _log(f"  kernel launches {launches}, twin primal calls on CUDA {twin_calls}")
    _log(f"  prop used {float(used.mean()):.6f} +/- {float(used.std()):.6f} kg")
    _log("  final means: " + ", ".join(f"{p} {res.dispersion_values_of(p)[0]:.6f}"
                                        for p in ("sma", "ecc", "inc")))
    if res.n_ok != B_SK:
        raise RuntimeError(f"station keeping: {res.n_ok}/{B_SK} lanes ok")
    if launches <= 0 or twin_calls != 0:
        raise RuntimeError(f"station keeping did not run through the kernel: {launches} launches, "
                           f"{twin_calls} twin primal calls on CUDA")
    if res.y_final.shape != (B_SK, 10) or not np.isfinite(res.y_final).all():
        raise RuntimeError("station keeping: final states are not finite [B, 10]")
    full_day_kg = SK_THRUST_N / (SK_ISP_S * STD_GRAVITY_M_S2) * SK_SECONDS
    if not ((used > 0.0) & (used <= full_day_kg)).all():
        raise RuntimeError(f"station keeping: prop used outside (0, {full_day_kg:.4f}] kg: {used}")

    y0 = res.y_initial[:B_SK_TWIN]
    end = sc.epoch + SK_TWIN_PREFIX_S
    t0 = time.perf_counter()
    kernel = MonteCarlo(mvn, seed=3).run_until_epoch(prop, alm, end, B_SK_TWIN, device="cuda", _y0=y0)
    t1 = time.perf_counter()
    twin = MonteCarlo(mvn, seed=3).run_until_epoch(propagator("torch"), alm, end, B_SK_TWIN,
                                                   device="cuda", _y0=y0)
    t2 = time.perf_counter()
    if kernel.n_ok != B_SK_TWIN or twin.n_ok != B_SK_TWIN:
        raise RuntimeError(f"station keeping reruns: {kernel.n_ok} and {twin.n_ok} of {B_SK_TWIN} ok")
    d_km = float(np.linalg.norm(twin.y_final[:, :3] - kernel.y_final[:, :3], axis=1).max())
    same_modes = bool(np.array_equal(twin.y_final[:, 9], kernel.y_final[:, 9]))
    _log(f"station keeping twin rerun of {B_SK_TWIN} lanes over {SK_TWIN_PREFIX_S:g} s (kernel {t1 - t0:.1f} s, "
         f"{kernel.iterations} iterations; twin {t2 - t1:.1f} s, {twin.iterations} iterations): max final "
         f"position difference {d_km:.3e} km, final modes {kernel.y_final[:, 9].tolist()} (kernel) and "
         f"{twin.y_final[:, 9].tolist()} (twin)")
    if not (d_km < SK_TWIN_TOL_KM and same_modes):
        raise RuntimeError(f"station keeping kernel and twin runs differ: {d_km} km, modes equal: {same_modes}")
    _log(f"station keeping phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, traj_per_s=res.n_ok / wall, wall=wall)


def _ex01_scene():
    """examples/01_orbit_prop.py:50-81 through the port: (spacecraft,
    propagator)."""
    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft
    from nyx_tpu_torch.constants import NAIF
    from nyx_tpu_torch.dynamics import (
        Drag, Harmonics, OrbitalDynamics, PointMasses, SolarPressure, SpacecraftDynamics,
    )
    from nyx_tpu_torch.io.gravity import GravityFieldData
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    epoch = Epoch.from_gregorian_utc(2024, 2, 29, 12, 13, 14)
    orbit = Orbit.keplerian(7136.6, 2e-4, 98.7, 30.0, 65.0, 80.0, epoch, Frames.EME2000)
    sc = Spacecraft.new(orbit, 150.0, 15.0, srp_area_m2=3.0, drag_area_m2=3.0, cr=1.8, cd=2.2)
    stor = GravityFieldData.from_cof(HERE / "data" / "JGM3.cof.gz", 21, 21, True, Frames.IAU_EARTH)
    dynamics = SpacecraftDynamics(
        OrbitalDynamics.from_models([Harmonics.from_stor(stor), PointMasses((NAIF.SUN, NAIF.MOON))],
                                    Frames.EME2000),
        (SolarPressure.default(), Drag.earth_exp()),
    )
    return sc, Propagator.rk89(dynamics, IntegratorOptions())


def phase_config1(gp, device="cuda"):
    """Config 1 on `device` (the card; "cpu" rehearses it): ex01's scene
    over EX01_SECONDS, its event, its exports and `until_event` on a fresh
    instance (a), then the GMAT truth (b). Returns the summary's numbers."""
    import tempfile

    import pyarrow.parquet as pq

    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.io.export import ExportCfg, read_oem, traj_table
    from nyx_tpu_torch.md.events import Event, find_events

    t_phase = time.perf_counter()
    sc, prop = _ex01_scene()
    alm = Almanac()
    _log(f"Config 1 initial: {sc}")
    prop.with_state(sc, alm, device=device).for_duration(60.0)  # warm-up: caches and allocator
    kernels, host_launches, ops = _eom_launch_count(prop, sc, alm, sc.to_vector()[None])
    _log(f"Config 1 EOM, one call at B=1 (torch.profiler): {kernels} CUDA kernels on the device, "
         f"{host_launches} kernel-launch calls from the host, {ops} top-level aten ops")

    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    inst = prop.with_state(sc, alm, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, traj = inst.for_duration_with_traj(EX01_SECONDS, n_capture=32768)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, f64_calls = gp.pines_accel_cuda.launches, gp.pines_accel_torch.cuda_calls
    res = inst.last_result
    iters = res.iterations
    days_per_min = EX01_SECONDS / 86_400.0 / (wall / 60.0)
    _log(f"Config 1 ({_card_line()}), ex01 over {EX01_SECONDS:g} s of its day, B=1:")
    _log(f"  wall {wall:.3f} s, {days_per_min:.4f} propagated days per wall minute")
    _log(f"  nodes {len(traj)}, accepted steps {int(res.n_accepted[0])}, rejected "
         f"{int(res.n_rejected[0])}, integrator iterations {iters}, {1e3 * wall / iters:.3f} ms an iteration")
    _log(f"  kernel launches {launches}: the 21x21 field is f64, whose recursion runs in the port's "
         f"f64 torch code, as the reference sends only float32 evaluations to Pallas")
    _log(f"  f64 recursion calls on CUDA {f64_calls}")
    _log(f"final: {final}")
    _log(str(traj))
    if launches != 0 or f64_calls <= 0:
        raise RuntimeError(f"Config 1: {launches} kernel launches (want 0), {f64_calls} f64 recursion calls")
    if not np.isfinite(traj.ys).all() or traj.ys.shape[1] != 9:
        raise RuntimeError("Config 1: trajectory nodes are not finite [K, 9]")

    found = find_events(traj, Event.apoapsis(), max_events=20)
    if len(found) != 1:
        raise RuntimeError(f"Config 1: {len(found)} apoapsis events in {EX01_SECONDS:g} s, want 1")
    ev = found[0]
    ta, t_ev = ev.state.orbit.ta_deg, (ev.epoch - sc.epoch).to_seconds()
    _log(f"  apoapsis at {ev.epoch} ({t_ev:.4f} s after the start): rmag {ev.state.orbit.rmag_km:.6f} km, "
         f"ta {ta:.6f} deg")
    if not (abs(min(ta, 360.0 - ta) - 180.0) < 0.05 and EX01_APOAPSIS_S[0] <= t_ev <= EX01_APOAPSIS_S[1]):
        raise RuntimeError(f"Config 1: apoapsis off (ta {ta} deg, {t_ev} s after the start)")
    with tempfile.TemporaryDirectory() as tmp:
        traj.to_parquet(Path(tmp) / "ex01_traj.parquet")
        traj.to_oem(Path(tmp) / "ex01_traj.oem")
        same = pq.read_table(Path(tmp) / "ex01_traj.parquet").equals(traj_table(traj, ExportCfg()))
        back = read_oem(Path(tmp) / "ex01_traj.oem", traj.template)
        d_oem = float(np.abs(back.ys[:, :6] - traj.ys[:, :6]).max()) if len(back) == len(traj) else np.inf
    _log(f"  parquet read back equal to the in-memory columns: {same}; OEM read back: {len(back)} nodes, "
         f"max difference {d_oem:.3e}")
    if not (same and d_oem < 1e-5):
        raise RuntimeError("Config 1: the parquet or OEM export does not read back")

    # until_event on a fresh instance on the card, from the timed arc's state
    # at the window's start to the arc's end (past the shadow's entry at
    # ~1,330 s, whose steps take most of the arc's iterations)
    t0 = time.perf_counter()
    t_from = EX01_APOAPSIS_S[0]
    fresh = prop.with_state(traj.at(sc.epoch + t_from), alm, device=device)
    stop, arc = fresh.until_event(EX01_SECONDS - t_from, Event.apoapsis())
    d_stop = abs((stop.epoch - ev.epoch).to_seconds())
    d_rmag = abs(stop.orbit.rmag_km - ev.state.orbit.rmag_km)
    d_end = float(np.linalg.norm(arc.last.orbit.r_km - final.orbit.r_km))
    _log(f"  until_event on a fresh instance from {t_from:g} s ({time.perf_counter() - t0:.1f} s, "
         f"{len(arc)} nodes, {fresh.last_result.iterations} iterations): {d_stop:.3e} s and {d_rmag:.3e} km "
         f"in rmag from the timed arc's event; its arc ends {d_end:.3e} km from the timed arc's final position")
    if not (d_stop < 0.1 and d_rmag < 1e-6 and d_end < 1e-6):
        raise RuntimeError(f"Config 1: until_event {d_stop} s and {d_rmag} km from the event, "
                           f"its arc ends {d_end} km off")
    _log(f"Config 1 (a): {time.perf_counter() - t_phase:.1f} s")
    gmat = phase_gmat(device)
    _log(f"Config 1 phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(wall=wall, days_per_min=days_per_min, iterations=iters, launches=launches,
                f64_calls=f64_calls, eom_kernels=kernels, gmat=gmat)


def phase_config5(gp, device="cuda"):
    """Config 5 on `device` (the card; "cpu" rehearses it): ex04's scene at
    full width (the 80x80 split field, six stations two-way, SNC, the
    3-sigma gate, stm_jvp_degree 8) over EX04_HOURS of its 24 h: the truth
    by `for_duration_with_traj`, timed, with one EOM call profiled; the
    simulated arc; `process_arc` over the first 1,800 s, then over the
    whole arc, timed; the guards; the truth's first EX04_TWIN_PREFIX_S
    through the kernel and the twin; and `to_frame(IAU_MOON)` and
    `groundtrack` of the truth on `device` against the CPU. Returns the
    summary's numbers."""
    from nyx_tpu_torch import Epoch, Frames
    from nyx_tpu_torch.od import MeasurementType, TrackingArcSim

    t_phase = time.perf_counter()
    seconds = EX04_HOURS * 3600.0
    stor = kaula_moon_field(80)
    scene = ex04_scene(stor, "split", device=device)
    prop, alm = scene.propagator("auto"), scene.almanac
    field = prop.dynamics.orbital_dyn.models[0]
    tab = field.packed_table(0, torch.float32, device)
    plan = gp.pines_launch_plan(tab.shape[0], tab.shape[2])
    _log(f"Config 5 field: {field.max_degree}x{field.max_order} split in IAU_MOON, table {tuple(tab.shape)}, launch plan "
         f"{'whole table' if plan.whole else f'streamed, buffers=2, chunk_steps={plan.chunk_steps}'}, "
         f"{plan.warps} warps, {plan.smem_bytes} B shared")
    prop.with_state(scene.truth, alm, device=device).for_duration(60.0)  # warm-up: caches and allocator

    # one EOM call at B = 1 by module: the IAU Moon DCM, the field (DCM,
    # J2+J3, the kernel), the whole EOM
    y1 = torch.as_tensor(scene.truth.to_vector()[None], device=device)
    t1 = torch.zeros(1, dtype=torch.float64, device=device)
    ctx = prop.dynamics.build_context(scene.truth.epoch, 600.0, alm, device=device)
    t_tdb = t1 + scene.truth.epoch.to_tdb_seconds()
    eom = prop.dynamics.make_eom()
    counts = {
        "IAU_MOON DCM": _kernel_count(lambda: Frames.IAU_MOON.dcm_from_j2000(t_tdb)),
        "Harmonics.accel (DCM, J2+J3, kernel)": _kernel_count(
            lambda: field.accel(ctx, t_tdb, y1[:, 0:3], y1[:, 3:6])),
        "whole EOM": _kernel_count(lambda: eom(t1, y1, ctx, dict(dry_mass_kg=0.0, srp_area_m2=0.0,
                                                                   drag_area_m2=0.0))),
    }
    for name, (kernels, host, ops) in counts.items():
        _log(f"Config 5 EOM at B=1, {name} (torch.profiler): {kernels} CUDA kernels, {host} launch calls "
             f"from the host, {ops} top-level aten ops")

    # 1. the truth
    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    inst = prop.with_state(scene.truth, alm, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, traj = inst.for_duration_with_traj(seconds)
    torch.cuda.synchronize()
    truth_wall = time.perf_counter() - t0
    truth_launches, truth_twin = gp.pines_accel_cuda.launches, gp.pines_accel_torch.cuda_calls
    res = inst.last_result
    ms_iter = 1e3 * truth_wall / res.iterations
    _log(f"Config 5 truth ({_card_line()}), ex04 over {EX04_HOURS:g} h of its 24 h, B=1: wall {truth_wall:.3f} s, "
         f"{len(traj)} nodes, accepted {int(res.n_accepted[0])}, rejected {int(res.n_rejected[0])}, "
         f"integrator iterations {res.iterations}, {ms_iter:.3f} ms an iteration; kernel launches "
         f"{truth_launches}, twin calls on CUDA {truth_twin}")
    if not np.isfinite(traj.ys).all() or traj.ts[-1] != seconds:
        raise RuntimeError("Config 5 truth: nodes are not finite or the arc is short")

    # 2. the arc
    t0 = time.perf_counter()
    arc = TrackingArcSim.with_seed(scene.stations, traj, {g.name: scene.cfg for g in scene.stations}, seed=4,
                                   device=device).generate_measurements(alm)
    _log(f"Config 5 arc: {len(arc)} two-way rows from {len(set(arc.tracker_idx.tolist()))} of "
         f"{len(scene.stations)} stations in {time.perf_counter() - t0:.3f} s")

    # 3. the filter: a warm-up over the first 1,800 s, then the whole arc, timed
    od = scene.od("auto")
    od.process_arc(scene.est0, _head(arc, 1800.0))
    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    gp.pines_tangent_torch.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = od.process_arc(scene.est0, arc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gp.pines_accel_cuda.launches
    twin_calls, tangent_calls = gp.pines_accel_torch.cuda_calls, gp.pines_tangent_torch.cuda_calls
    w = od.stage_walls_s
    rate = len(arc) / wall
    truth_fin = traj.at(Epoch.from_tai_seconds_j2000(float(sol.epochs_tai_s[-1]))).to_vector()
    err_km = float(np.linalg.norm(sol.final_state()[:3] - truth_fin[:3]))
    acc = ~np.asarray(sol.rejected)
    ridx = sol.types.index(MeasurementType.RANGE_KM)
    rms_km = float(np.sqrt(np.mean(sol.postfit[acc, ridx] ** 2)))
    beyond = 100.0 * float(np.mean(sol.ratio > 3.0))
    _log(f"Config 5 filter ({_card_line()}), segmented EKF, timed process_arc:")
    _log(f"  rows {len(arc)}, segments {w['segments']}, s1 iterations {w['s1_iterations']}")
    _log(f"  wall {wall:.3f} s, {rate:.2f} rows/s")
    _log("  stage walls summed over the segments: " + ", ".join(f"{k} {w[k]:.3f} s" for k in ("s1", "s2", "s3", "s4")))
    _log(f"  kernel launches {launches}, twin primal calls on CUDA {twin_calls}, twin tangent calls {tangent_calls}")
    _log(f"  final position error vs truth {err_km * 1e3:.3f} m, sigma (max axis) "
         f"{1e3 * float(np.sqrt(np.diag(sol.final_covar())[:3]).max()):.3f} m")
    _log(f"  range postfit RMS {rms_km * 1e3:.3f} m; {int((~acc).sum())} rows rejected by the 3-sigma gate; "
         f"{beyond:.2f} % of residual ratios beyond 3 sigma")
    if sol.y_est.shape != (len(arc), 9) or not np.isfinite(sol.y_est).all():
        raise RuntimeError("Config 5 filter: estimates are not finite [M, 9]")
    if truth_launches <= 0 or launches <= 0 or truth_twin != 0 or twin_calls != 0:
        raise RuntimeError(f"Config 5 did not run through the kernel: {truth_launches} and {launches} launches, "
                           f"{truth_twin} and {twin_calls} twin calls on CUDA")
    if not err_km < OD_GUARD_KM:
        raise RuntimeError(f"Config 5 filter diverged: {err_km * 1e3:.1f} m final error")
    if not rms_km < EX04_POSTFIT_RMS_KM:
        raise RuntimeError(f"Config 5 range postfit RMS {rms_km * 1e3:.3f} m")

    # 5. the twin witness: the truth's first EX04_TWIN_PREFIX_S through the
    # kernel and with the twin forced
    finals = {}
    for backend in ("auto", "torch"):
        finals[backend] = scene.propagator(backend).with_state(scene.truth, alm, device=device).for_duration(
            EX04_TWIN_PREFIX_S).orbit.r_km
    d_twin = float(np.linalg.norm(finals["auto"] - finals["torch"]))
    _log(f"Config 5 twin witness over the first {EX04_TWIN_PREFIX_S:g} s: final positions {d_twin:.3e} km apart")
    if not d_twin < 1e-9:
        raise RuntimeError(f"Config 5: kernel and twin truths differ by {d_twin} km")

    # 6. the frame transform and the ground track on the card against the CPU
    body = traj.to_frame(Frames.IAU_MOON, device=device)
    body_cpu = traj.to_frame(Frames.IAU_MOON, device="cpu")
    track = traj.groundtrack(step=60.0, device=device)
    track_cpu = traj.groundtrack(step=60.0, device="cpu")
    d_body = float(np.abs(body.ys[:, :6] - body_cpu.ys[:, :6]).max())
    d_track = max(float(np.abs(a - b).max()) for a, b in zip(track[1:], track_cpu[1:]))
    _log(f"Config 5 to_frame(IAU_MOON) of {len(traj)} nodes and groundtrack of {len(track[0])} samples "
         f"(altitude {track[3].min():.3f}-{track[3].max():.3f} km): {d_body:.3e} km and {d_track:.3e} "
         f"(deg, km) from the CPU")
    if not (d_body < 1e-9 and d_track < 1e-9):
        raise RuntimeError(f"Config 5: the card's to_frame / groundtrack differ from the CPU's by {d_body}, {d_track}")
    _log(f"Config 5 phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, truth_launches=truth_launches, rows_per_s=rate, truth_ms_per_iter=ms_iter,
                rows=len(arc), wall=wall, err_km=err_km)


def phase_gmat(device="cuda"):
    """GMAT's one-day two-body truth through `integrator.propagate` on
    `device`: the five adaptive tableaus (RSSCartesianState, 0.1-30 s,
    1e-12) and RK4Fixed at 10 s. Returns the largest error of each run."""
    from nyx_tpu_torch.constants import GM
    from nyx_tpu_torch.propagators import ErrorControl, IntegratorMethod, IntegratorOptions
    from nyx_tpu_torch.propagators.integrator import DONE, propagate

    mu = GM.GMAT_EARTH

    def eom(t, y):
        r = y[..., 0:3]
        rmag = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
        return torch.cat([y[..., 3:6], -mu * r / rmag**3], dim=-1)

    opts = IntegratorOptions.with_adaptive_step(0.1, 30.0, 1e-12, ErrorControl.RSSCartesianState)
    y0 = torch.tensor([GMAT_Y0], dtype=torch.float64, device=device)
    out = {}

    def run(label, y, seconds, options, method):
        t0 = time.perf_counter()
        res = propagate(eom, y, seconds, options, method)
        if int(res.status[0]) != DONE:
            raise RuntimeError(f"GMAT {label}: the run did not finish")
        _log(f"  {label}: {int(res.n_accepted[0])} steps, {res.iterations} iterations, "
             f"{time.perf_counter() - t0:.1f} s")
        return res

    for name, truth in GMAT_TRUTH.items():
        res = run(name, y0, 86_400.0, opts, IntegratorMethod(name))
        err = np.abs(res.y[0].cpu().numpy() - np.array(truth))
        tol = GMAT_TOL.get(name, 1e-8)
        _log(f"  {name} vs GMAT: position {err[:3].max():.3e} km, velocity {err[3:].max():.3e} km/s "
             f"(bound {tol:g})")
        if not (err[:3].max() < tol and err[3:].max() < tol):
            raise RuntimeError(f"GMAT {name}: off the truth by {err}")
        out[name] = float(err.max())
    res = run("RK4Fixed at 10 s", y0, 86_400.0, IntegratorOptions.with_fixed_step(10.0), IntegratorMethod.RK4Fixed)
    err = float(np.linalg.norm(res.y[0, :3].cpu().numpy() - np.array(GMAT_TRUTH["RK89"][:3])))
    _log(f"  RK4Fixed vs the RK89 truth: {err:.3e} km")
    if not (int(res.n_accepted[0]) == 8640 and err < 1e-3):
        raise RuntimeError(f"GMAT RK4Fixed: {int(res.n_accepted[0])} steps, {err} km")
    out["RK4Fixed"] = err
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration-s", type=float, default=86_400.0,
                    help="arc of the main-path run (default: one day)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit (say, unpacked by git archive) whose "
                         "own kernel and wrapper are built and timed beside this one at 21x21")
    args = ap.parse_args()

    # phase 1: the card
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    _log(_card_line())
    kind = torch.cuda.get_device_name(0)

    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft, _cuda
    from nyx_tpu_torch.dynamics import (
        Drag, Harmonics, OrbitalDynamics, SolarPressure, SpacecraftDynamics,
    )
    from nyx_tpu_torch.dynamics import gravity_pines as gp
    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.io.gravity import GravityFieldData
    from nyx_tpu_torch.mc import MonteCarlo, MvnSpacecraft, StateDispersion
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    # phase 2: build
    parent, builds = None, [("pines", _cuda)]
    if args.parent is not None:
        parent = _parent_gravity(args.parent.resolve())
        builds.append(("the parent's pines", parent._cuda))
    for label, cuda in builds:
        built = cuda.load("pines")
        _log(f"built {label}: {built.path} in {built.seconds:.2f} s")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                _log(f"  ptxas: {line.strip()}")

    # phase 3: kernel vs twin
    jgm3 = HERE / "data" / "JGM3.cof.gz"
    stor70 = GravityFieldData.from_cof(jgm3, 70, 70, True, Frames.IAU_EARTH)
    stor8 = GravityFieldData.from_cof(jgm3, 8, 8, True, Frames.IAU_EARTH)
    fields = {
        "8x8": Harmonics.from_stor(stor8, "split"),
        "21x21": Harmonics.from_stor(
            GravityFieldData.from_cof(jgm3, 21, 21, True, Frames.IAU_EARTH), "split"),
        "12x6": Harmonics.from_stor(
            GravityFieldData.from_cof(jgm3, 12, 6, True, Frames.IAU_EARTH), "f32"),
        "70x70": Harmonics.from_stor(stor70, "split"),
        "120x120": Harmonics.from_stor(extend_kaula(stor70, 120, 7), "split"),
        "160x160": Harmonics.from_stor(extend_kaula(stor70, 160, 8), "split"),
        "moon80x80": Harmonics.from_stor(kaula_moon_field(80), "split"),
    }
    k3 = phase_kernel_vs_twin(gp, fields, parent)

    # phases 4 and 5: the main path, Config 2, and its twin rerun
    epoch = Epoch.from_gregorian_utc(2021, 3, 4)
    orbit = Orbit.keplerian(7136.6, 2e-4, 51.6, 30.0, 65.0, 80.0, epoch, Frames.EME2000)
    sc = Spacecraft.new(orbit, 100.0, 0.0, 2.0, 2.0, 1.8, 2.2)

    def propagator_for(stor):
        def propagator(backend):
            dyn = SpacecraftDynamics(
                OrbitalDynamics.from_model(
                    Harmonics.from_stor(stor, precision="split", backend=backend), Frames.EME2000
                ),
                (SolarPressure.default(), Drag.earth_exp()),
            )
            return Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9))
        return propagator

    mvn = MvnSpacecraft(
        sc, [StateDispersion("sma", 0.5), StateDispersion("inc", 0.01), StateDispersion("raan", 0.01)]
    )
    alm = Almanac()
    if args.duration_s != 86_400.0:
        _log(f"NOTE: main-path arc shortened to {args.duration_s} s (not the one-day Config 2)")

    prop21 = propagator_for(GravityFieldData.from_cof(jgm3, 21, 21, True, Frames.IAU_EARTH))
    warm = MonteCarlo(mvn, seed=42).run_until_epoch(prop21("auto"), alm, epoch + 120.0, B_MAIN,
                                                    device="cuda")
    if warm.n_ok != warm.n_runs:
        raise RuntimeError(f"warm-up: {warm.n_ok}/{warm.n_runs} lanes ok")
    launches = run_and_rerun(42, mvn, prop21, alm, epoch, args.duration_s, gp, "main path")

    # phase 6: 70x70 JGM3 split over half an hour through the kernel, and its twin rerun
    launches70 = run_and_rerun(42, mvn, propagator_for(stor70), alm, epoch, SECONDS_70X70, gp, "70x70 path")

    # phase 6b: the OD leg; 6c: the flagship OD leg on its truth
    stor21 = GravityFieldData.from_cof(jgm3, 21, 21, True, Frames.IAU_EARTH)
    od = phase_od(gp, stor21)
    flagship = phase_od_flagship(gp, stor21, od["truth"], od["traj"])

    # phase 6d: Config 4, the station-keeping Monte Carlo
    geo_sk = phase_geo_sk(gp, stor8)

    # phase 6e: Config 1, one spacecraft, and the GMAT truth
    phase_config1(gp)

    # phase 6f: Config 5, lunar orbit determination on the 80x80 field
    config5 = phase_config5(gp)

    # phase 7: summary
    _log(f"chip_smoke.py command time: {time.perf_counter() - _T_START:.1f} s")
    ms21, bound21, bound_by = k3["times"]["21x21"]
    ms70, bound70, _ = k3["times"]["70x70"]
    ms120, bound120, _ = k3["times"]["120x120"]
    print(json.dumps({"kernels": [{
        "name": "pines_accel",
        "route": "cuda",
        "source": "nyx_tpu_torch/csrc/pines.cu",
        "replaces": "nyx_tpu/dynamics/gravity_pallas.py:71",
        "launches": launches,
        "max_abs_err": k3["max_abs"],
        "max_rel_err": k3["max_rel"],
        "ms": ms21,
        "ms_timing": "cuda_graph_replay",
        "plain_ms": k3["twin_ms"],
        "eager_ms": k3["eager_ms"],
        "plain_eager_ms": k3["twin_eager_ms"],
        "bound_ms": bound21,
        "bound_by": bound_by,
        "library_ms": None,
        "parent_ms": k3["parent_ms"],
        "parent_eager_ms": k3["parent_eager_ms"],
        "launches_70x70": launches70,
        "ms_70x70": ms70,
        "bound_ms_70x70": bound70,
        "ms_120x120": ms120,
        "bound_ms_120x120": bound120,
        "launches_od": od["launches"],
        "od_rows_per_s": od["rows_per_s"],
        "launches_od_flagship": flagship["launches"],
        "od_flagship_rows_per_s": flagship["rows_per_s"],
        "launches_geo_sk": geo_sk["launches"],
        "geo_sk_traj_per_s": geo_sk["traj_per_s"],
        "launches_config5": config5["launches"],
        "launches_config5_truth": config5["truth_launches"],
        "config5_rows_per_s": config5["rows_per_s"],
        "config5_truth_ms_per_iter": config5["truth_ms_per_iter"],
        "ms_80x80_b1": k3["times"]["moon80x80_b1"][0],
        "bound_ms_80x80_b1": k3["times"]["moon80x80_b1"][1],
        f"ms_80x80_b{B_EX04_STM}": k3["times"][f"moon80x80_b{B_EX04_STM}"][0],
        f"bound_ms_80x80_b{B_EX04_STM}": k3["times"][f"moon80x80_b{B_EX04_STM}"][1],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
