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
3b. hold the fused EOM (csrc/eom.cu: eom_pre, the Pines kernel, eom_post)
   against the composed PyTorch EOM on the same card tensors at Config 2's
   composition with the 21x21 and the 70x70 field, at B = 10,000 LEO lanes
   spread over the day (accelerations within 1e-12 km/s^2, the Pines input
   within 2 f32 ulps of the composed rotation, the velocity columns equal
   and the last three zero, one fused and one composed evaluation counted);
   time eom_pre and eom_post at B = 10,000 and at 2M lanes beside the least
   time their bytes take, and one whole evaluation fused and composed back
   to back from the host;
4. run the main path, after a 120 s warm-up arc, and count kernel launches
   and fused EOM evaluations (one a Pines launch: every evaluation fused);
5. rerun 64 of its lanes over the day's first hour through the kernel and
   with the gravity twin forced, and compare finals;
6. the same ensemble with 70x70 JGM3 split gravity over a quarter hour,
   through the kernel, and its 64-lane twin rerun;
6b. the bench's OD leg (bench.py:279-404) through the port: a one-day
   truth by `for_duration_with_traj`, DSS-65/34/13 range and Doppler every
   60 s by `TrackingArcSim`, and `ScanKalmanOD` (CKF, stm_jvp_degree 8,
   f32 algebra) over the whole arc after a 1-hour warm-up arc, timed, with
   its kernel launches counted; the bench's 100 m guard against the
   truth; the warm-up arc again with the gravity twin forced (every row
   within 1e-3 km of the warm-up's) and with f64 algebra
   (TestF32FilterAlgebra's bounds);
6c. the bench's flagship OD leg (bench.py:407-434) on 6b's truth: the
   same stations two-way (60 s integration), simulated by
   `TrackingArcSim`, and the segmented EKF (`variant="ekf"`, SNC, 3-sigma
   gate, stm_jvp_degree 8, f32 algebra) from a dispersed start, after a
   1-hour warm-up arc, timed over the arc's first 6 h with its kernel launches
   counted; the bench's 100 m guard; the warm-up arc again through the
   gravity twin (every row within 1e-3 km of the warm-up's) and with f64
   algebra (TestF32FilterAlgebra's bounds, the same rejections);
6d. Config 4 of BASELINE.md, the GEO station-keeping Monte Carlo
   (examples/03_geo_analysis.py:248-350): 25 lanes, 8x8 JGM3 split,
   Sun and Moon point masses, SRP with an Earth shadow, a 0.472 N /
   4,435 s thruster under the eclipse-gated Ruggiero law, RK89 at 1e-10
   with a 30 s floor, over 6 h of its 30 days, after a 600 s warm-up, with
   its kernel launches counted and one EOM call's CUDA launches profiled;
   then 4 of its lanes over the first hour through the kernel and the twin
   (final positions within 1e-6 km, the same final modes);
6e. Config 1 of BASELINE.md, one spacecraft (examples/01_orbit_prop.py:
   50-93): (a) the example's scene (LEO, 21x21 JGM3 at f64, Sun and Moon,
   SRP, drag, RK89 at 1e-12) through `Propagator.rk89(...).with_state(sc,
   almanac)` and `for_duration_with_traj` with n_capture 32,768, over a cut
   depth of 3,600 s of the example's day (at B = 1 an iteration launches
   ~15,000 kernels, ~0.2-0.3 s; the hour holds the arc's first apoapsis,
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
   depth of 1 h of its 24 h (half a revolution): the truth by
   `for_duration_with_traj`, timed, with one EOM call profiled by module;
   six polar IAU_MOON stations, two-way, simulated by `TrackingArcSim`; the
   segmented EKF (SNC, 3-sigma gate, stm_jvp_degree 8) over the first
   1,800 s, then over the whole arc, timed; guards: kernel launches on the
   truth and the timed arc, no twin primal call on CUDA, the final estimate
   within 100 m of the truth, range postfit RMS under 5 m; the truth's
   first 600 s through the kernel and the twin (within 1e-9 km); and
   `Trajectory.to_frame(IAU_MOON)` and `groundtrack` of the truth on the
   card against the CPU (within 1e-9);
6g. Config 3 of BASELINE.md, covariance mapping and a Monte Carlo
   (examples/02_jwst_covar_monte_carlo.py:39-163), at full width: the
   180,000 km, e = 0.7 orbit with Sun and Moon point masses and SRP with
   the Earth's and the Moon's shadows, RK89 at 1e-12 (no field, so no
   kernel launch), over the first 2 of its 6.5 days; (a)
   `ScanKalmanOD.predict_for` at 60 s (2,880 estimates), timed, the
   covariance symmetric and PSD; (b) the
   5,000-lane `run_until_epoch` with 256 capture nodes over the 2 days
   after a 300 s warm-up, timed (5,000/5,000 ok, sample 0 the initial
   state, the MC over mapped position-sigma ratio within [0.95, 1.05]);
   (c) `to_parquet` of the finals and of every node, read back; (d) the
   example's Encke mode (ABM, dt 600 s, 256 nodes) on the same draws, its
   finals within 2e-3 km of (b)'s and its sigmas within 1e-3; (e) Config
   2's Encke mode at the bench's defaults (bench.py:164-171: fixed step,
   ABM, automatic dt) at B = 10,000 over phase 5's hour, timed after a
   first call that builds its reference: the float32 perturbation's field
   through the kernel (launches counted, no twin primal call on CUDA), the
   first 64 lanes within 2e-3 km of phase 5's 64-lane full-state kernel
   run, and within 1e-9 km of the same lanes through the twin;
6h. mission design, the reference's scenes at their published sizes: (a)
   the targeter from tests/test_targeting.py's LEO (sma half an orbit
   later by FD and by dual, the VNC sma and ecc pair, a position target)
   in two-body, then under 21x21 JGM3 split at 1e-10 through the kernel
   (the sma solves a quarter orbit later, a depth cut that paid for phase
   6n; launches counted, no twin primal call on CUDA), and FD's and the
   dual's first Newton iterations towards the same sma a sixteenth of an
   orbit later through the kernel and the twin (corrections within 1e-12
   km/s; FD's whole solve through the twin, the dual's towards a quarter
   orbit, until phase 6m needed the time);
   (b) finite-burn targeting (`thrust_dir`, `thrust_dir_rate`) and
   `convert_impulsive_mnvr`, each maneuver flown again and held to the
   rocket equation; (c) the 3-node minimum-fuel multiple shooting; (d) the
   Earth -> Mars porkchop over the 2020 window at one day (43,200 cells)
   and test_lambert.py's 12 x 12 grid, each against the CPU; (e) Davis'
   B-plane, test_sequence.py's sequence, and the state-carried STM over
   half an orbit under the split field against central differences;
   printed as "Mission design phase";
6i. the tracking side of OD, printed as "Tracking phase": (a) ex05
   (examples/05_caps_interlink_od.py:62-233), the CAPS crosslink OD: the
   NRHO transmitter and the 110 km polar LLO receiver with Earth and Sun
   point masses over the OD's 2 h (a depth cut of the example's 12 h
   truths), link-budget noises, one manual strand, the randomized start,
   the segmented EKF with the 3-sigma gate, timed, its residual-versus-
   reference run and three parquets, held to the port's CPU counts and
   error and to the reference's 167.76 m; no field, so no kernel launch;
   (b) ex06 (examples/06_lunar_od.py:90-290), Earth-tracked lunar OD over
   the first 36 min of its 2 days: the 50x50 lunar field at split precision
   through the kernel with Earth, Sun and Jupiter point masses and SRP,
   three DSN stations saved to YAML, read back and given centre-offset
   tables to the Moon, a tracking YAML, the zero-noise cross-body CKF over
   the first half hour (range prefits under 1e-4 km), the segmented EKF (SNC, 3-sigma gate,
   stm_jvp_degree 8, segment_rows 8) from a 500 m / 5 mm/s dispersed
   start, timed, with its kernel launches (no twin primal call on CUDA),
   its final error under half the initial one; and the truth's first
   600 s through the kernel and the twin (within 1e-9 km);
6j. ex03's remainder (examples/03_geo_analysis.py), printed as "ex03
   phase": (a) the GEO drift bench (:54-116; 21x21 split, Sun and Moon,
   SRP with the Earth's and the Moon's shadows, RK89 at 1e-9, B = 1), a
   600 s warm-up, then one day of the published 1,095 through the kernel,
   timed, in propagated days a minute beside the reference's 560; (b) the
   GTO raise (:119-212; 8x8 f64, the eclipse-gated Ruggiero law) over its
   first 6 h of up to 180 days, held to the port's CPU run; (c) the
   eclipse scan (:214-228) over a two-body day from (b)'s end, against
   the CPU on the same trajectory; (d) raise_optim's first generation
   (:353-530) at P = 20 over 6 h of 60 days, two lanes rerun alone;
6k. the OD host loop, printed as "Host OD phase": ex06's host branch
   (examples/06_lunar_od.py:235-245, `KalmanODProcess`, one measurement
   at a time) on 6i's scene over the arc's first half hour (the rows of
   6i's zero-noise CKF), through the kernel, held to the scan EKF's counts
   and its estimate at the same row (1.1 times the reference's own two
   filters' gap on this scene, 5.2e-3 km) and to the same loop run on the
   CPU on the same rows (1e-6 km), with a lower bound on a row's CUDA
   kernels from two profiles, then the smoother and the statistics;
6l. the scan filter's modes on 6b's scene, printed as "Scan modes phase":
   (a) the associative-scan filter's iterated 4-sigma gate against the
   sequential scan's, both f64, on the arc's first 6 h with ~3 % of the
   range rows moved by +5 km (the same rejections, the moved rows among
   them, final estimates within 1e-6 km); (a') the associative-scan filter
   over the whole day, timed, its s4 beside 6b's; (b) `process_arc_batch`
   over 64 estimates at 6b's settings (6b's estimate and 63 draws from its
   covariance) over the day, timed, member 0 within 1e-9 km of 6b's
   solution; (c) Gauss-Markov range biases on DSS-65 and DSS-34 over 6 h,
   estimated as state lanes and recovered within 3 sigma + 1 m; (d)
   `prop_mode` "fixed" and "adaptive" over the arc's first 8 rows against
   the batch CKF; (e) the spacecraft and integrator options through TOML,
   the propagator's Dhall document and the spacecraft through DER; every
   filter through the kernel;
6m. the file-driven high-fidelity Earth dynamics on Config 2's scene and
   width (ROADMAP Queue 1 items 5 and 6), printed as "hifi phase": the
   21x21 JGM3 field written as an EGM2008 text file and read back by
   `from_egm2008`, the Moon and the Sun written as SPK type-3 files from
   the analytic almanac and read back by `Almanac([moon, sun])` (all in a
   temporary directory), `Harmonics` at f64 precision, the Moon's and the
   Sun's point masses, solid tides, SRP and the 1976 atmosphere, with
   `pert_precision="f32"`, so the kernel runs the whole field at q_lo 0 in
   every stage; (a) B = 10,000 over the day's first hour (a depth cut),
   timed, launches counted, no twin call on CUDA; over the hour's first
   300 s, lanes 0-63 (b) through the kernel and the twin (within 1e-3
   km), (c) with f64 perturbations (within 1 m of (b)), (d) 16 of them on
   the CPU (within 1e-3 km of (b)); the depth cuts of 6h paid for it;
6n. ensembles sharded over a mesh of devices (parallel/mesh.py), printed
   as "Mesh phase": the mesh of every card present and 3 shards of one
   card, each shard a host thread under a CUDA stream of its own; (a)
   Config 2 at B = 10,000 over the day's first hour unsharded, on every
   card and on the 3 shards (10,000 is no multiple of 3: padding), timed,
   launches counted by shard and summed, 10,000/10,000 ok and every final
   within 1e-9 km of the unsharded run's, the shards of the one card in
   turn; (b) Config 2's Encke mode (ABM) at B = 20 over 1 h on the shards
   against one device, inside `tracing.profile_trace` over the card's
   activity, the trace's Pines kernels as many as the launch counter
   moved; (c) `process_arc_batch` over 8 filters (CKF,
   f64 algebra) on 6b's arc's first 2 h on the shards against the
   unsharded batch (finals within 1e-9 km, the same rejections); the
   depth cut of 6h(a) paid for it; multi-card scaling is not measured on
   a one-card machine;
7. print the command time and the summary.

The second-to-last line of output is the kernels' JSON summary, the last
line `{"ok": true, "device": {...}}`. In the summary `ms` is the card's
time a call, from a CUDA graph of 20 calls replayed back to back
(`ms_timing`); `eager_ms` is the time a call made back to back from the
host, as the main path makes them (for `eom_post`, one whole fused
evaluation, and `plain_eager_ms` the composed one's). Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from types import SimpleNamespace

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
# day (6 h until Config 5's phase needed the time, 2 h until the tracking
# phase did), and phase 6's 70x70 ensemble runs over its first quarter hour
# (one hour until Config 5's phase needed the time, half an hour until
# Config 3's did).
TWIN_PREFIX_S = 3600.0
SECONDS_70X70 = 900.0
# Phase 3b, the fused EOM against the composed one: the card test's bounds
# (tests/test_torch_fused_eom.py; room for the f32 field's rounding, the H100
# gave 0 and 0), the benchmark's width, and the bytes a lane moves (t and y
# in, 80; eom_pre writes r_bf, 12; eom_post reads a_bf, 12, and writes ydot,
# 72).
FUSED_TOL_KM_S2 = 1e-12
FUSED_PRE_ULPS = 2
B_FUSED_WIDE = 2_000_000
EOM_PRE_BYTES = 92
EOM_POST_BYTES = 164
# The OD legs' warm-up arc, whose rows the twin and f64 reruns repeat (2 h
# until Config 3's phase needed the time, 1 h until the scan filter's modes
# did), and the flagship leg's timed arc,
# the first 6 h of its day (the whole day until Config 3's phase needed the
# time, 57-142 s on NVIDIA H100 80GB HBM3 cards at 700 W; 12 h until the ex03
# and host-OD phases did).
OD_WARM_S = 1800.0
FLAGSHIP_SECONDS = 21_600.0
# Config 4's station keeping (examples/03_geo_analysis.py:248-350): its 25
# lanes over 6 h of the 30 days (one day until Config 3's phase needed the
# time, 8 h until mission design's did; the day took 95-169 s on NVIDIA
# H100 80GB HBM3 cards at 700 W), a NEXT-STEP-class thruster, and 4 lanes in
# the kernel-vs-twin rerun. At 6 h every lane has thrusted and stopped
# (0.159-0.176 kg on the CPU, under the 0.234 kg of 6 h at full thrust);
# at 4 h every lane would still thrust, at the guard's bound.
B_SK = 25
B_SK_TWIN = 4
SK_SECONDS = 6 * 3600.0
# its kernel-vs-twin rerun's prefix (6 h until Config 5's phase needed the
# time, 4 h until Config 3's did, 2 h until the ex03 and host-OD phases did)
SK_TWIN_PREFIX_S = 3600.0
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
# is where `until_event`'s fresh instance starts. (The first 1,800 s take
# 416 of the hour's 432 iterations on the card: the shadow's entry at
# ~1,330 s holds most of them, so a shorter arc saves little.)
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
# frame, the example's 24 h arc cut to 1 h (half a revolution of the 1.93 h
# orbit; 6 h took phase 6f 225 s, 4 h 156 s, 3 h 181 s and 2 h 82.5-92.5 s on
# NVIDIA H100 80GB HBM3 cards at 700 W; 4 h until Config 3's phase needed the
# time, 2 h until the tracking phase did), the range postfit RMS guard, km,
# and the twin witness's prefix.
EX04_MU = 4902.800066
EX04_HOURS = 1.0
EX04_POSTFIT_RMS_KM = 5e-3
EX04_TWIN_PREFIX_S = 600.0
# Config 3 (examples/02_jwst_covar_monte_carlo.py): its 5,000 lanes over the
# first 2 days of its 6.5 (the whole 6.5 days until the ex03 and host-OD
# phases needed the time) with 256 capture nodes (every step); the window of the
# Monte Carlo's position sigmas over the mapped ones (the example's own run
# gave 0.99; the sampling error at N = 5,000 is ~1 %); and the Encke bounds:
# the deviation lanes against the full state, km (tests/test_torch_config3.py's
# own, 2e-3 km, where it measures 2.9e-6 km over ex02's first day at B = 8),
# and the kernel's Encke against the twin's.
EX02_B = 5_000
EX02_DAYS = 2.0
EX02_N_CAPTURE = 256
EX02_RATIO = (0.95, 1.05)
ENCKE_FULL_TOL_KM = 2e-3
ENCKE_TWIN_TOL_KM = 1e-9
# Mission design (phase 6h), the reference's scenes (tests/test_targeting.py,
# test_lambert.py, test_sequence.py): their epoch; the split field's
# tolerance (at 1e-12 its f32 part sets the step); kernel vs twin, km/s; dual
# vs FD, km/s: 1e-6 in two-body (test_targeting.py:104), and under the split
# field 1e-6 on the corrections' magnitudes: there the FD Jacobian (1e-6 km/s
# perturbations) sees the f32 field's rounding, and Newton's min-norm steps
# land at other points of the solution set (one objective, three
# variables): the reference's own dual and FD corrections part by 4.6e-6
# km/s (JAX on the CPU), the port's FD moves 1.2e-5 km/s between the CPU
# and the card, their magnitudes agree within 1e-6; the rocket equation, kg; the
# impulsive conversion's bounds (test_targeting.py:302-303); multiple
# shooting's total delta-v, km/s, and node misses, km (:168-180); porkchop,
# the card against the CPU, relative, in every finite cell but the
# ill-conditioned ones, which are held to MD_PORKCHOP_SENS times their own
# rounding sensitivity (their relative change on the CPU under a
# MD_PORKCHOP_EPS relative change of the departure positions): one cell of
# the 2020 grid (97 days, C3 176 km^2/s^2, a transfer angle near 180 deg)
# moves 7.4e-8 under 1e-15 and differs 4.5e-7 between the card and the CPU;
# the window's minimum C3 (test_lambert.py:134);
# the STM against central differences (steps 1e-2 km, 1e-5 km/s) on the
# entries of at least a tenth of the largest, relative; Davis' B-plane
# targeting delta-v (test_targeting.py:45-47), km/s.
MD_EPOCH = (2020, 1, 1)
MD_SPLIT_TOL = 1e-10
# the split field's sma solves (FD and dual) aim this much of an orbit
# ahead (the reference's half until phase 6n needed the time)
MD_SPLIT_SMA_ORBITS = 0.25
MD_TWIN_TOL_KM_S = 1e-12
MD_DUAL_FD_KM_S = 1e-6
MD_ROCKET_KG = 1e-6
MD_CONVERT_KM, MD_CONVERT_KM_S = 0.02, 2e-5
MD_MS_DV_KM_S, MD_MS_NODE_KM = 2.0, 2e-3
MD_PORKCHOP_REL, MD_PORKCHOP_SENS, MD_PORKCHOP_EPS = 1e-9, 100.0, 1e-15
MD_C3 = (8.0, 25.0)
MD_STM_REL, MD_STM_BIG = 1e-5, 0.1
MD_CD_KM, MD_CD_KM_S = 1e-2, 1e-5
DAVIS_DV = (-0.25386251697606466, -0.18774460089778605, 0.046145009839345504)
# ex05 (examples/05_caps_interlink_od.py): both truths over the OD's 2 h, not
# the example's 12 h (its NYX_EX05_TX_HOURS knob; the manual strand's first
# 75 samples, the OD's rows, are the same either way), and the OD arc. The
# port's CPU run (tests/test_torch_tracking_od.py holds it to these and to
# the reference): rows, acceptances and final position error, m; the card
# must give the same counts and an error within EX05_CPU_TOL_M of it; and the
# reference's own artifact (examples/artifacts/ex05_cpu.json, 167.76 m) with
# the card's bound from it.
EX05_HOURS = 2.0
EX05_OD_S = 7200.0
EX05_CPU_ROWS = 75
EX05_CPU_ACCEPTED = 75
EX05_CPU_ERROR_M = 167.76494370031148
EX05_CPU_TOL_M = 1.0
EX05_REFERENCE_ERROR_M = 167.76
EX05_REFERENCE_TOL_M = 5.0
# ex06 (examples/06_lunar_od.py): its 50x50 field at split precision, over
# the first 36 min of its 2 days (the first hour until the ex03 and host-OD
# phases needed the time; the arc's first half hour, 6k's rows, is the same
# either way); the zero-noise cross-body CKF's span (the arc's first half
# hour) and its range prefit bound, km (tests/test_od.py:1940-1945); and the
# twin witness's prefix.
EX06_DEGREE = 50
EX06_HOURS = 0.6
EX06_CKF_S = 1800.0
EX06_PREFIT_KM = 1e-4
EX06_TWIN_PREFIX_S = 600.0
# ex06's EKF runs segments of M <= segment_rows = 8 rows; its stage 2 folds
# the 9 forward-mode passes into the batch, so the kernel sees B = 9 M <= 72
# lanes, about the 150 km orbit's perilune and apolune radii.
EX06_SEGMENT_ROWS = 8
B_EX06_STM = 9 * EX06_SEGMENT_ROWS
EX06_RADII_KM = (1_883.4, 1_891.4)
# ex03 (examples/03_geo_analysis.py), phase 6j. (a) The drift bench's
# warm-up and timed arc (the published arc is 1,095 days, at the
# reference's ~560 propagated days a minute); (b) the GTO raise over its
# first 6 h of up to 180 days, held to the port's CPU run of the same arc
# (chip_smoke.phase_geo_ex03 on the CPU): the signs of its changes of sma,
# eccentricity and propellant (near perigee the 8x8 field's short-period
# terms outweigh 6 h of thrust in the osculating sma), its propellant left
# within EX03_RAISE_CPU_KG, and its final position within
# EX03_RAISE_CPU_KM. The raise is not continuous in its start: the steering
# switches and drives RK89 to its 1 s floor ~1,550 s in, so a 1e-12 change
# of the start moves the final position by 0.07-0.15 km on the CPU (8
# draws; the reference's own runs 0.034 km apart under a 1e-12 km change,
# and 0.096 km from the port's), while the propellant stays equal to the
# bit; the bound is ~3x that spread; (c) the eclipse scan's step, the
# card's percentages against the CPU's on the same trajectory and its
# events' epochs, s; (d) raise_optim's generation: P lanes over 6 h of the
# published 60 days, two of them rerun alone, their propellant within
# EX03_OPTIM_RERUN_KG.
EX03_DRIFT_WARM_S = 600.0
EX03_DRIFT_DAYS = 1.0
EX03_DRIFT_REFERENCE_DAYS_PER_MIN = 560.0
EX03_RAISE_S = 6 * 3600.0
EX03_RAISE_CPU_R_KM = (-41_338.2760638242, -4_240.682234843085, -520.0874626855089)
EX03_RAISE_CPU_V_KM_S = (0.5920016422799954, -1.5759198714402383, -0.1936940711950485)
EX03_RAISE_CPU_PROP_KG = 999.8307018169245
EX03_RAISE_CPU_DSMA_KM = -68.56169088665047
EX03_RAISE_CPU_DECC = -0.0018255474702411068
EX03_RAISE_CPU_USED_KG = 0.1692981830755116
EX03_RAISE_CPU_KM = 0.5
EX03_RAISE_CPU_KG = 1e-9
EX03_ECLIPSE_STEP_S = 300.0
EX03_ECLIPSE_PCT_TOL = 1e-9
EX03_ECLIPSE_EVENT_S = 1e-3
EX03_OPTIM_P = 20
EX03_OPTIM_S = 6 * 3600.0
# raise_optim's lanes rerun alone at B = 1, each to the bit of its lane in
# the generation (lanes 0 and 1 until the scan filter's modes needed the
# time: the two reruns took 56.3-87.4 s on NVIDIA H100 80GB HBM3 cards at
# 700 W, half of phase 6j)
EX03_OPTIM_RERUN_LANES = (0,)
EX03_OPTIM_RERUN_KG = 1e-9
# ex06's host loop (examples/06_lunar_od.py:235-245), phase 6k: the rows of
# the arc's first EX06_CKF_S (those of 6i's zero-noise CKF); the host loop's
# bound against the scan EKF at the same row, km: 1.1 times the reference's
# own two filters' gap on this scene (devtools/ex06_filter_gap.py 50:
# 4.728e-3 km after the 31 rows, on the CPU; at degree 8 both packages part
# by 2.0e-4 km, inside the 1e-3 km of tests/test_od.py:435). The whole
# 50x50 field enters the host loop's STM and only degree 8 the scan EKF's
# (stm_jvp_degree), and the dispersed start (500 m, 5 mm/s) is 36 m from
# the truth after the rows.
EX06_HOST_SCAN_KM = 1.1 * 4.728e-3
# the host loop's twin witness: the rows of its first EX06_HOST_TWIN_S
EX06_HOST_TWIN_S = 180.0
# the port's host loop on the CPU, run from the same start on the card's
# rows of the arc's first EX06_HOST_CPU_S (its 31 rows over 1,800 s until
# the scan filter's modes needed the time: 23.7-24.1 s on the CPU; 16 rows
# over 900 s, 20.7-22.6 s and 5.055e-7 km apart, until the mesh phase did),
# its final estimate against the card's at that row, km
EX06_HOST_CPU_S = 450.0
EX06_HOST_CPU_KM = 1e-6
# Phase 6l, the scan filter's modes on 6b's scene: (a) the parallel filter's
# gate parity over the arc's first SCAN_GATE_S (~3 % of the range rows moved
# by +5 km, the scene of tests/test_od.py:652-690), its final estimate within
# SCAN_PARALLEL_KM of the sequential scan's; (b) the ensemble of
# SCAN_ENSEMBLE_B filters (member 0 6b's estimate, the others drawn from its
# covariance at SCAN_ENSEMBLE_SEED), member 0 within SCAN_MEMBER_KM of 6b's
# solution (the reference's member-vs-solo bound, tests/test_od.py:1364-1368);
# (c) the bias lanes over SCAN_BIAS_S at SCAN_BIAS_CADENCE_S; (d) the per-row
# modes over the arc's first SCAN_ROWS rows, each within SCAN_ROW_KM of the
# port's batch CKF on the same rows: the tests' 1e-6 km, or 1.1 times the
# reference's own gap between the same modes on this scene where that is
# larger (`reference_row_gap(8)` of tests/test_torch_scan_modes.py, on the
# CPU: 7.554e-9 km for both modes; the port's on the CPU 2.03e-8 km). 12
# rows took 10.8-14.8 s of (d) on NVIDIA H100 80GB HBM3 cards at 700 W,
# past 6l's 60 s in one run.
SCAN_GATE_S = 6 * 3600.0
SCAN_PARALLEL_KM = 1e-6
SCAN_ENSEMBLE_B = 64
SCAN_ENSEMBLE_SEED = 12
SCAN_MEMBER_KM = 1e-9
SCAN_BIAS_S = 6 * 3600.0
SCAN_BIAS_CADENCE_S = 120.0
SCAN_ROWS = 8
SCAN_REFERENCE_ROW_GAP_KM = 7.553769e-9
SCAN_ROW_KM = max(1e-6, 1.1 * SCAN_REFERENCE_ROW_GAP_KM)
# Phase 6m, the file-driven high-fidelity Earth dynamics on Config 2's scene
# and width: the first HIFI_SECONDS of its day (a depth cut); HIFI_B_TWIN
# of its lanes over the first HIFI_RERUN_S through the twin (held to
# TWIN_FINAL_TOL_KM against the kernel's run of the same lanes) and with f64
# perturbations (held to HIFI_F64_TOL_KM: the reference's claim for its f32
# stack, spacecraft_dyn.py:52-58), HIFI_B_CPU of them on the CPU (held to
# TWIN_FINAL_TOL_KM). The f32 perturbations take 8 integrator iterations
# over 300 s, 16 over 600-900 s and 96 over the hour (the hour's reruns
# took 47-51 s on NVIDIA H100 80GB HBM3 cards at 700 W). The SPK files
# cover the ephemeris table's 2-day pad and a day more on each side (the
# reader clamps to its edge records).
HIFI_SECONDS = 3600.0
HIFI_RERUN_S = 300.0
HIFI_B_TWIN = 64
HIFI_B_CPU = 16
HIFI_F64_TOL_KM = 1e-3
HIFI_SPK_MARGIN_DAYS = 3.0
# f32 against f64 filter algebra (tests/test_od.py:1782-1792): positions
# (km) and sigmas (relative).
OD_F32_POS_KM = 2e-3
OD_F32_SIGMA_REL = 0.05
# The card's peaks (NVIDIA H100 SXM data sheet): 67 TFLOP/s of f32 counts a
# fused multiply-add as two operations; the kernel is built without
# contraction, so each of its operations is one instruction at half that.
F32_OPS_PER_S = 67e12 / 2
# Phase 6n, ensembles on a mesh: Config 2 over the day's first hour; the
# shards of one card (B_MAIN = 10,000 is no multiple of 3, so the padding
# runs); every sharded final within MESH_TOL_KM of its unsharded run's.
# Depth cuts, for the script's time: Encke's 2 h to 1 h, the filters' 6 h
# to 2 h
MESH_SECONDS = 3600.0
MESH_SHARDS = 3
MESH_TOL_KM = 1e-9
MESH_ENCKE_B = 20
MESH_ENCKE_SECONDS = 3600.0
MESH_OD_FILTERS = 8
MESH_OD_SECONDS = 2 * 3600.0

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


def ex02_scene(*, device="cuda"):
    """The scene of examples/02_jwst_covar_monte_carlo.py:41-96 through the
    port's own names: the 180,000 km, e = 0.7 orbit in EME2000 (i 28 deg),
    a 6,200 kg spacecraft with 100 m^2 of SRP area at Cr 1.3, Sun and Moon
    point masses, SRP with the Earth's and the Moon's shadows, RK89 at the
    default options (1e-12); the RIC uncertainty (0.5, 0.3, 1.5 km; 1e-4,
    3e-4, 2e-4 km/s) as the initial estimate, the covariance-mapping filter
    (DSS-65 at a 10 deg mask, range and Doppler) and the Monte Carlo's
    dispersion (`MvnSpacecraft.from_covariance` of the estimate's
    covariance). Returns a namespace of them."""
    from types import SimpleNamespace

    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft
    from nyx_tpu_torch.constants import NAIF
    from nyx_tpu_torch.dynamics import OrbitalDynamics, PointMasses, SolarPressure, SpacecraftDynamics
    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.mc import MvnSpacecraft
    from nyx_tpu_torch.od import GroundStation, MeasurementType, ScanKalmanOD, SpacecraftUncertainty
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    almanac = Almanac()
    epoch = Epoch.from_gregorian_utc(2024, 6, 1, 0, 0, 0)
    orbit = Orbit.keplerian(180_000.0, 0.7, 28.0, 80.0, 90.0, 140.0, epoch, Frames.EME2000)
    sc = Spacecraft.new(orbit, 6200.0, 0.0, srp_area_m2=100.0, drag_area_m2=0.0, cr=1.3, cd=0.0)
    dyn = SpacecraftDynamics(
        OrbitalDynamics.from_models([PointMasses((NAIF.SUN, NAIF.MOON))], Frames.EME2000),
        (SolarPressure.cislunar(),),
    )
    prop = Propagator.rk89(dyn, IntegratorOptions())
    est0 = SpacecraftUncertainty(nominal=sc, frame="ric", x_km=0.5, y_km=0.3, z_km=1.5,
                                 vx_km_s=1e-4, vy_km_s=3e-4, vz_km_s=2e-4).to_estimate()
    scan = ScanKalmanOD(prop, [GroundStation.dss65_madrid(10.0)],
                        types=(MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S),
                        almanac=almanac, device=device)
    return SimpleNamespace(epoch=epoch, sc=sc, prop=prop, almanac=almanac, est0=est0, scan=scan,
                           mvn=MvnSpacecraft.from_covariance(sc, est0.covar))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _LaunchesByThread:
    """`gp.pines_accel_cuda` wrapped to tally its launches by the name of the
    host thread that made them (a mesh's shards run in threads of their
    own). It stands in the module's global while a phase runs, so the
    kernel's own `pines_accel_cuda.launches += 1` finds it there:
    `launches` reads and writes through to the kernel's counter."""

    def __init__(self, kernel):
        self.kernel, self.tally, self.lock = kernel, collections.Counter(), threading.Lock()

    def __call__(self, *args, **kwargs):
        out = self.kernel(*args, **kwargs)
        with self.lock:
            self.tally[threading.current_thread().name] += 1
        return out

    @property
    def launches(self):
        return self.kernel.launches

    @launches.setter
    def launches(self, n):
        self.kernel.launches = n


@contextlib.contextmanager
def _launches_by_thread(gp):
    """A Counter of the kernel's launches inside the context by host thread
    (`_LaunchesByThread`); the kernel's own counter still counts."""
    wrapped = gp.pines_accel_cuda = _LaunchesByThread(gp.pines_accel_cuda)
    try:
        yield wrapped.tally
    finally:
        gp.pines_accel_cuda = wrapped.kernel


def ex05_flow(tx_hours: float = EX05_HOURS, *, device="cuda", out_dir=None):
    """examples/05_caps_interlink_od.py:62-233 through the port's own names,
    on `device`: the NRHO transmitter (given in EME2000, integrated in
    MOON_J2000) and the 110 km polar LLO receiver, Moon-centred with Earth
    and Sun point masses, RK89 at 1e-9 with a 30 s step cap, both
    propagated over `tx_hours` (the example's NYX_EX05_TX_HOURS, 12 h by
    default; the OD needs the first 2 h); the link-budget noises (an SA-45
    CSAC clock, 10 s integration); the crosslink simulated over one manual
    strand (60 s, seed 0); the randomized RIC estimate (1 km, 1 m/s, draw
    from `np.random.default_rng(0)`, covariance x 2.5); the process device
    with 3x white noise; the segmented EKF with the 3-sigma gate over the
    first 2 h, its residual-versus-reference run, and both parquet exports
    into `out_dir` (when given). Returns a namespace of the results and
    each stage's wall."""
    from dataclasses import replace

    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft
    from nyx_tpu_torch.constants import NAIF
    from nyx_tpu_torch.cosmic.orbit import ric_dcm
    from nyx_tpu_torch.dynamics import OrbitalDynamics, PointMasses, SpacecraftDynamics
    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.od import (
        InterlinkTxSpacecraft, MeasurementType, ScanKalmanOD, SpacecraftUncertainty, StochasticNoise,
        TrackingArcSim, TrkConfig, WhiteNoise,
    )
    from nyx_tpu_torch.od.noise import CN0, SN0, CarrierFreq, ChipRate
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    walls = {}

    def timed(name, fn):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        walls[name] = time.perf_counter() - t0
        return out

    alm = Almanac()
    moon = Frames.MOON_J2000
    epoch = Epoch.from_gregorian_tai(2021, 5, 29, 19, 51, 16.852)
    nrho = Orbit.cartesian(166_473.631_302_239_7, -274_715.487_253_382_7, -211_233.210_176_686_7,
                           0.933_451_604_520_018_4, 0.436_775_046_841_900_9, -0.082_211_021_250_348_95,
                           epoch, Frames.EME2000)
    dyn = SpacecraftDynamics.new(OrbitalDynamics.from_models([PointMasses((NAIF.EARTH, NAIF.SUN))], moon))
    setup = Propagator.rk89(dyn, replace(IntegratorOptions.with_adaptive_step(0.1, 30.0, 1e-9),
                                         integration_frame=moon))
    prop_time = tx_hours * 3600.0
    tx_inst = setup.with_state(Spacecraft.from_orbit(nrho), alm, device=device)
    _, tx_traj = timed("tx truth", lambda: tx_inst.for_duration_with_traj(prop_time, n_capture=16384))
    llo_orbit = Orbit.keplerian(1737.4 + 110.0, 1e-4, 90.0, 0.0, 0.0, 0.0, epoch, moon)
    llo_sc = Spacecraft.from_orbit(llo_orbit)
    llo_inst = setup.with_state(llo_sc, alm, device=device)
    _, llo_traj = timed("llo truth", lambda: llo_inst.for_duration_with_traj(prop_time, n_capture=16384))
    iterations = tx_inst.last_result.iterations + llo_inst.last_result.iterations

    allan = 1e-11  # the SA-45 CSAC
    noises = {
        MeasurementType.RANGE_KM: StochasticNoise.from_hardware_range_km(
            allan, 10.0, ChipRate.StandardT4B, SN0.Average),
        MeasurementType.DOPPLER_KM_S: StochasticNoise.from_hardware_doppler_km_s(
            allan, 10.0, CarrierFreq.SBand, CN0.Average),
    }
    link = InterlinkTxSpacecraft(tx_traj, name="NRHO Tx SC", occulting_radius_km=1737.4)
    link.stochastic_noises = noises
    cfg = TrkConfig(sampling_s=60.0, strands=[(epoch, epoch + prop_time)])
    arc = timed("simulation", lambda: TrackingArcSim.with_seed(
        [link], llo_traj, {link.name: cfg}, seed=0, device=device).generate_measurements())

    unc = SpacecraftUncertainty(nominal=llo_sc, frame="ric", x_km=1.0, y_km=1.0, z_km=1.0,
                                vx_km_s=1e-3, vy_km_s=1e-3, vz_km_s=1e-3)
    est0, dispersed = unc.to_estimate_randomized(np.random.default_rng(0))
    est0 = replace(est0, nominal=dispersed, covar=est0.covar * 2.5)
    proc = InterlinkTxSpacecraft(tx_traj, name="NRHO Tx SC", occulting_radius_km=1737.4)
    proc.stochastic_noises = {t: StochasticNoise(WhiteNoise(n.white_noise.sigma * 3.0))
                              for t, n in noises.items()}
    od = ScanKalmanOD(setup, [proc], types=(MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S),
                      variant="ekf", resid_rejection_sigmas=3.0, almanac=alm, device=device)
    arc_2h = arc.filter_by_offset(0.0, EX05_OD_S)
    sol = timed("od", lambda: od.process_arc(est0, arc_2h))
    od_walls = dict(od.stage_walls_s)
    rvr = timed("resid vs ref", lambda: od.process_arc(est0, arc_2h.resid_vs_ref_check()))

    truth = llo_traj.at(Epoch.from_tai_seconds_j2000(float(sol.epochs_tai_s[-1])))
    r_t, v_t = np.asarray(truth.orbit.r_km), np.asarray(truth.orbit.v_km_s)
    err = sol.final_state()[:3] - r_t
    dcm = ric_dcm(torch.tensor(r_t), torch.tensor(v_t)).numpy()
    paths = []
    if out_dir is not None:
        paths = [arc.to_parquet(Path(out_dir) / "05_nrho_interlink_msr.parquet"),
                 sol.to_parquet(Path(out_dir) / "05_caps_interlink_od_sol.parquet"),
                 rvr.to_parquet(Path(out_dir) / "05_caps_interlink_resid_v_ref.parquet")]
    return SimpleNamespace(
        tx_traj=tx_traj, llo_traj=llo_traj, arc=arc, arc_2h=arc_2h, est0=est0, dispersed=dispersed, sol=sol,
        rvr=rvr, noises=noises, od=od, walls=walls, od_walls=od_walls, iterations=iterations, paths=paths,
        init_err_m=1e3 * float(np.linalg.norm(dispersed.orbit.r_km - llo_orbit.r_km)),
        err_ric_m=1e3 * (dcm @ err), err_m=1e3 * float(np.linalg.norm(err)),
        prop_err_m=1e3 * float(np.linalg.norm(rvr.final_state()[:3] - r_t)))


def ex06_moon_field(n_max: int = EX06_DEGREE, seed: int = 7):
    """examples/06_lunar_od.py:62-83 as numpy, into the port's
    GravityFieldData: the lunar J2 and C22, and from degree 3 fully
    normalized C/S of Kaula-rule magnitude (3.5e-4 / n^2 times a standard
    normal from `np.random.default_rng(seed)`, C before S at each order),
    GM 4,902.800066 km^3/s^2, radius 1,737.4 km, in IAU_MOON. (Config 5's
    `kaula_moon_field` draws from degree 2 and sets only C20.)"""
    from nyx_tpu_torch import Frames
    from nyx_tpu_torch.io.gravity import GravityFieldData

    rng = np.random.default_rng(seed)
    c = np.zeros((n_max + 1, n_max + 1))
    s = np.zeros((n_max + 1, n_max + 1))
    c[2, 0] = -9.088e-5
    c[2, 2] = 3.467e-5
    for n in range(3, n_max + 1):
        k = 3.5e-4 / n**2
        for m in range(0, n + 1):
            c[n, m] = rng.normal() * k
            if m > 0:
                s[n, m] = rng.normal() * k
    c[0, 0] = 1.0
    return GravityFieldData(c_nm=c, s_nm=s, mu_km3_s2=EX04_MU, radius_km=1737.4, frame=Frames.IAU_MOON)


def ex06_scene(stor, precision: str = "split", *, yaml_dir, device="cuda"):
    """The scene of examples/06_lunar_od.py:90-205 through the port's own
    names, on the field `stor` (`ex06_moon_field`): the 150 km lunar
    orbiter (e 0.00212, i 33.6 deg) in MOON_J2000, 1,018 kg dry and 900 kg
    of propellant, 10.53 m^2 of SRP area at Cr 0.96; the field with Earth,
    Sun and Jupiter-barycentre point masses and SRP with the Moon's shadow,
    RK89 at 1e-10 with a 60 s step cap (the example's accelerator
    options); DSS-65, DSS-34 and DSS-13 at a 5 deg mask, one-way range and
    Doppler with 2 m and 3 mm/s white noise, saved to
    `yaml_dir`/dsn-network.yaml and read back with `load_named`; the
    tracking file `yaml_dir`/tracking-cfg.yaml, 60 s sampling, eager
    hand-off, min_samples 10, read back with `load_trk_configs` (the
    example reads both from the reference's fixtures, which are not in the
    repository: these are the port's stated choice); the RIC uncertainty
    (500 m, 5 mm/s) with one randomized draw from
    `np.random.default_rng(123)`; the SNC of 1e-14 km/s over 3,600 s,
    disabled beyond 600 s gaps; and the filter factory (`od(stations,
    backend, variant, stm_jvp_degree=8)`: the segmented EKF with the
    3-sigma gate and segment_rows 8, or the CKF without SNC or gate).
    `stations(start, end)` gives the YAML's stations each
    `with_target_frame(almanac, NAIF.MOON, start, end)`. Returns a namespace
    of them."""
    from dataclasses import replace

    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft
    from nyx_tpu_torch.constants import NAIF
    from nyx_tpu_torch.dynamics import (
        Harmonics, OrbitalDynamics, PointMasses, SolarPressure, SpacecraftDynamics,
    )
    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.io.config import load_trk_configs
    from nyx_tpu_torch.od import (
        GroundStation, MeasurementType, ProcessNoise, ScanKalmanOD, SpacecraftUncertainty, StochasticNoise,
        WhiteNoise,
    )
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    alm = Almanac()
    moon = Frames.MOON_J2000
    epoch = Epoch.from_gregorian_utc(2024, 2, 29, 12, 0, 0.0)
    orbit = Orbit.keplerian(1737.4 + 150.0, 0.00212, 33.6, 45.0, 45.0, 0.0, epoch, moon)
    orbiter = Spacecraft.new(orbit, 1018.0, 900.0, 3.9 * 2.7, 0.0, 0.96, 2.2)

    def propagator(backend):
        dyn = SpacecraftDynamics(
            OrbitalDynamics.from_models(
                [Harmonics.from_stor(stor, precision=precision, backend=backend),
                 PointMasses((NAIF.EARTH, NAIF.SUN, NAIF.JUPITER_BARYCENTER))], moon),
            (SolarPressure.default(NAIF.MOON),))
        return Propagator.rk89(dyn, IntegratorOptions(tolerance=1e-10, max_step_s=60.0))

    yaml_dir = Path(yaml_dir)
    dsn = [GroundStation.dss65_madrid(5.0), GroundStation.dss34_canberra(5.0),
           GroundStation.dss13_goldstone(5.0)]
    for gs in dsn:
        gs.stochastic_noises = {MeasurementType.RANGE_KM: StochasticNoise(WhiteNoise(2.0e-3)),
                                MeasurementType.DOPPLER_KM_S: StochasticNoise(WhiteNoise(3.0e-6))}
    from nyx_tpu_torch.io.config import save_ground_stations

    save_ground_stations(dsn, yaml_dir / "dsn-network.yaml")
    trk = {gs.name: {"sampling": "1 min", "scheduler": {"handoff": "Eager", "cadence": "Continuous",
                                                          "min_samples": 10}} for gs in dsn}
    with open(yaml_dir / "tracking-cfg.yaml", "w") as f:
        import yaml

        yaml.safe_dump(trk, f, sort_keys=False)
    devices = GroundStation.load_named(yaml_dir / "dsn-network.yaml")
    configs = load_trk_configs(yaml_dir / "tracking-cfg.yaml")

    def stations(start, end):
        return [gs.with_target_frame(alm, NAIF.MOON, start, end) for gs in devices.values()]

    unc = SpacecraftUncertainty(nominal=orbiter, frame="ric", x_km=0.5, y_km=0.5, z_km=0.5,
                                vx_km_s=5e-3, vy_km_s=5e-3, vz_km_s=5e-3)
    est0, dispersed = unc.to_estimate_randomized(np.random.default_rng(123))
    est0 = replace(est0, nominal=dispersed)
    snc = ProcessNoise.from_velocity_km_s([1e-14] * 3, 3600.0, disable_time_s=600.0)
    types = (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S)

    def od(st, backend="auto", variant="ekf", stm_jvp_degree=8):
        if variant == "ckf":
            return ScanKalmanOD(propagator(backend), st, types=types, variant="ckf", almanac=alm,
                                stm_jvp_degree=stm_jvp_degree, device=device)
        return ScanKalmanOD(propagator(backend), st, types=types, variant="ekf", process_noise=(snc,),
                            resid_rejection_sigmas=3.0, almanac=alm, stm_jvp_degree=stm_jvp_degree,
                            segment_rows=EX06_SEGMENT_ROWS, device=device)

    return SimpleNamespace(epoch=epoch, orbit=orbit, orbiter=orbiter, propagator=propagator, almanac=alm,
                           devices=devices, configs=configs, stations=stations, unc=unc, est0=est0,
                           dispersed=dispersed, snc=snc, od=od)


def ex06_host_od(scene, backend="auto", *, device="cuda"):
    """examples/06_lunar_od.py:235-245, the example's host branch
    (NYX_EX06_HOST) through the port: the per-measurement `KalmanODProcess`
    on `scene`'s propagator (`ex06_scene`), the EKF with its SNC and the
    3-sigma gate, on `device`. Its STM takes the whole field's partials;
    the scan EKF's take the field cut to degree 8 (`stm_jvp_degree`)."""
    from nyx_tpu_torch.od import KalmanODProcess, KalmanVariant

    return KalmanODProcess(scene.propagator(backend), (scene.snc,), KalmanVariant.ReferenceUpdate,
                           resid_rejection_sigmas=3.0, almanac=scene.almanac, device=device)


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
             ("moon80x80", 3, ((1, B_EX04_STM, B_MAIN), LUNAR_RADII_KM)),
             # phase 6i's ex06 field at its orbit's radii, at the q_lo its split
             # field passes: the truth's single lane and stage 2's 9 M lanes
             ("moon50x50", 0, ((1, 9, B_EX06_STM), EX06_RADII_KM))]
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


def _f32_ulps(a, b) -> int:
    """Largest distance in f32 units in the last place between `a` and `b`."""
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def _leo_lanes(B: int, seed: int, day_s: float = 86_400.0):
    """(t_rel [B], y [B, 9]) on the card: LEO radii in random directions,
    circular speeds in random directions, Config 2's Cr and Cd, times
    spread over `day_s`."""
    from nyx_tpu_torch import Frames

    r = _body_fixed(B, seed)
    rng = np.random.default_rng(seed + 1)
    rmag = np.linalg.norm(r, axis=1, keepdims=True)
    w = rng.normal(size=(B, 3))
    w -= np.sum(w * r, axis=1, keepdims=True) * r / rmag**2
    v = w / np.linalg.norm(w, axis=1, keepdims=True) * np.sqrt(Frames.EME2000.mu / rmag)
    y = np.concatenate([r, v, np.tile([1.8, 2.2, 0.0], (B, 1))], axis=1)
    k = dict(dtype=torch.float64, device="cuda")
    return torch.as_tensor(rng.uniform(0.0, day_s, B), **k), torch.as_tensor(y, **k)


def phase_fused_eom(gp, fields, epoch, sc_params):
    """Phase 3b: the fused EOM (dynamics/fused_eom.py, csrc/eom.cu) against
    the composed PyTorch EOM on the same card tensors, at Config 2's
    composition (split field, SRP with the Earth's shadow, exponential drag)
    with the 21x21 and the 70x70 field, at B_MAIN lanes; then eom_pre and
    eom_post timed at B_MAIN and B_FUSED_WIDE beside the least time their
    bytes take, and one whole evaluation, fused and composed, back to back
    from the host. Returns the summary's numbers."""
    from nyx_tpu_torch import Frames
    from nyx_tpu_torch.constants import NAIF, RADIUS_BY_NAIF
    from nyx_tpu_torch.cosmic.eclipse import illumination_factor
    from nyx_tpu_torch.cosmic.rotations import apply_dcm, iau_earth_dcm32_pole
    from nyx_tpu_torch.dynamics import Drag, OrbitalDynamics, SolarPressure, SpacecraftDynamics
    from nyx_tpu_torch.dynamics import fused_eom as F
    from nyx_tpu_torch.ephem import Almanac

    t_phase = time.perf_counter()
    alm = Almanac()
    t, y = _leo_lanes(B_MAIN, 3000 + B_MAIN)
    out = dict(max_gap=0.0, max_ulps=0, eager_ms={}, plain_eager_ms={})
    for name in ("21x21", "70x70"):
        dyn = SpacecraftDynamics(OrbitalDynamics.from_model(fields[name], Frames.EME2000),
                                 (SolarPressure.default(), Drag.earth_exp()))
        plan = F.plan_for(dyn, with_stm=False)
        if plan is None:
            raise RuntimeError(f"fused EOM: Config 2's composition at {name} has no fused plan")
        ctx = dyn.build_context(epoch, 86_400.0, alm, device="cuda")
        eom = dyn.make_eom()
        n0 = (F.fused_eom.launches, F.fused_eom.composed_calls, gp.pines_accel_cuda.launches)
        fused = eom(t, y, ctx, sc_params)
        composed = eom.composed(t, y, ctx, sc_params)
        torch.cuda.synchronize()
        moved = (F.fused_eom.launches - n0[0], F.fused_eom.composed_calls - n0[1],
                 gp.pines_accel_cuda.launches - n0[2])
        gap = (fused[:, 3:6] - composed[:, 3:6]).abs().max().item()
        n_diff = int((fused[:, 3:6] != composed[:, 3:6]).any(dim=1).sum())
        same_v = torch.equal(fused[:, :3], y[:, 3:6]) and torch.equal(fused[:, :3], composed[:, :3])
        zero = not bool(fused[:, 6:].any())
        c = plan.consts(ctx, sc_params)
        dcm32, _ = iau_earth_dcm32_pole(ctx.epoch0_tdb + t)
        ulps = _f32_ulps(F.eom_pre(t, y, c), apply_dcm(dcm32, y[:, :3].to(torch.float32)))
        r32 = y[:, :3].to(torch.float32)
        sun_pos = ctx.table.position(ctx.table.index_of(NAIF.SUN), ctx.epoch0_tdb + t, dtype=torch.float32)
        k = illumination_factor(sun_pos - r32, [(-r32, RADIUS_BY_NAIF[NAIF.EARTH])])
        fused_ms = _eager_ms(lambda: eom(t, y, ctx, sc_params))
        composed_ms = _eager_ms(lambda: eom.composed(t, y, ctx, sc_params))
        _log(f"fused EOM vs composed, Config 2 at {name}, B={B_MAIN} ({int((k == 1).sum())} sunlit, "
             f"{int(((k > 0) & (k < 1)).sum())} penumbral, {int((k == 0).sum())} umbral lanes): "
             f"acceleration gap {gap:.3e} km/s^2 ({n_diff} lanes differ), eom_pre within {ulps} f32 ulps "
             f"of the composed rotation, velocities equal {same_v}, columns 6-8 zero {zero}; "
             f"(fused, composed, Pines) counters moved by {moved}; one evaluation back to back from the "
             f"host: fused {fused_ms:.4f} ms, composed {composed_ms:.4f} ms")
        if moved != (1, 1, 2):
            raise RuntimeError(f"fused EOM at {name}: counters moved by {moved}, not (1, 1, 2)")
        if not (gap <= FUSED_TOL_KM_S2 and ulps <= FUSED_PRE_ULPS and same_v and zero):
            raise RuntimeError(f"fused EOM at {name}: gap {gap} km/s^2 (bound {FUSED_TOL_KM_S2}), "
                               f"eom_pre {ulps} ulps (bound {FUSED_PRE_ULPS}), velocities equal "
                               f"{same_v}, columns 6-8 zero {zero}")
        out["max_gap"], out["max_ulps"] = max(out["max_gap"], gap), max(out["max_ulps"], ulps)
        out["eager_ms"][name], out["plain_eager_ms"][name] = fused_ms, composed_ms
        if name != "21x21":
            continue
        tab, kw = plan.field.packed_table(0, torch.float32, "cuda"), plan.field.pines_args()
        sun = ctx.table.coeffs[ctx.table.index_of(NAIF.SUN)]
        for B in (B_MAIN, B_FUSED_WIDE):
            tB, yB = (t, y) if B == B_MAIN else _leo_lanes(B, 3000 + B)
            a_bf = gp.pines_accel_cuda(F.eom_pre(tB, yB, c), tab, 0, **kw)
            pre_ms = _time_ms(lambda: F.eom_pre(tB, yB, c))
            post_ms = _time_ms(lambda: F.eom_post(tB, yB, a_bf, sun, c))
            pre_bound, post_bound = (1e3 * B * n / HBM_BYTES_PER_S for n in (EOM_PRE_BYTES, EOM_POST_BYTES))
            _log(f"fused EOM kernels at B={B}: eom_pre {pre_ms:.4f} ms per call, bound {pre_bound:.4f} ms "
                 f"(bytes, {100 * pre_bound / pre_ms:.1f} %); eom_post {post_ms:.4f} ms per call, bound "
                 f"{post_bound:.4f} ms (bytes, {100 * post_bound / post_ms:.1f} %)")
            out[B] = dict(pre_ms=pre_ms, pre_bound=pre_bound, post_ms=post_ms, post_bound=post_bound)
            del tB, yB, a_bf
    _log(f"fused EOM phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def run_and_rerun(mc_seed, mvn, propagator, alm, start, seconds, gp, label):
    """A B_MAIN-lane ensemble through the kernel, with its launches counted
    from 0, then B_TWIN of its lanes through the gravity twin over the arc's
    first min(seconds, TWIN_PREFIX_S), held against the ensemble's finals
    where that is the whole arc, else against a fresh B_TWIN-lane kernel
    run of the prefix. Every EOM evaluation of the ensemble is fused (one
    fused evaluation a kernel launch). Returns the launches, the fused
    evaluations and the kernel's Results over the prefix (its first B_TWIN
    lanes are the twin's)."""
    from nyx_tpu_torch.dynamics.fused_eom import fused_eom
    from nyx_tpu_torch.mc import MonteCarlo

    end = start + seconds
    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    fused_eom.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = MonteCarlo(mvn, seed=mc_seed).run_until_epoch(propagator("auto"), alm, end, B_MAIN, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fused = gp.pines_accel_cuda.launches, fused_eom.launches
    twin_cuda_calls = gp.pines_accel_torch.cuda_calls
    _log(f"{label}: B={B_MAIN}, {seconds} s arc, wall {wall:.3f} s, "
         f"{res.n_ok / wall:.2f} traj/s, mean accepted steps {float(np.mean(res.n_accepted)):.2f}, "
         f"mean rejected {float(np.mean(res.n_rejected)):.2f}, iterations {res.iterations}, "
         f"n_ok/n_runs {res.n_ok}/{res.n_runs}, kernel launches {launches}, "
         f"fused EOM evaluations {fused}, twin CUDA calls {twin_cuda_calls}")
    if res.n_ok != res.n_runs:
        raise RuntimeError(f"{label}: {res.n_ok}/{res.n_runs} lanes ok")
    if res.y_final.shape != (B_MAIN, 9) or not np.isfinite(res.y_final).all():
        raise RuntimeError(f"{label}: final states are not finite [B, 9]")
    if launches <= 0 or twin_cuda_calls != 0:
        raise RuntimeError(
            f"{label} did not run through the kernel: {launches} launches, "
            f"{twin_cuda_calls} twin calls on CUDA"
        )
    if fused != launches:
        raise RuntimeError(f"{label}: {fused} fused EOM evaluations for {launches} kernel launches "
                           f"(every evaluation launches the kernel once, and every one should fuse)")

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
    return launches, fused, kernel


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

    warm_arc = _head(arc, OD_WARM_S)
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
    _log(f"OD warm-up, first {OD_WARM_S:g} s ({len(warm_arc)} rows): {syncs} synchronizing calls flagged "
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
    _log(f"OD twin rerun of the first {OD_WARM_S:g} s ({len(warm_arc)} rows): max row position difference "
         f"{d_twin:.3e} km")
    if not d_twin < TWIN_FINAL_TOL_KM:
        raise RuntimeError(f"OD kernel and twin runs differ by {d_twin} km")

    _f32_vs_f64(f"OD, first {OD_WARM_S:g} s,", warm, od("auto", "f64").process_arc(est0, warm_arc))
    return dict(launches=launches, rows_per_s=rate, rows=len(arc), wall=wall, truth=truth,
                traj=traj, arc=arc, est0=est0, sol=sol, stations=stations,
                s4=scan.stage_walls_s["s4"])


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
    warm_arc = _head(arc, OD_WARM_S)
    warm = scan.process_arc(est, warm_arc)  # warm-up; the reruns below are held to it
    arc = _head(arc, FLAGSHIP_SECONDS)

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
    _log(f"OD flagship twin rerun of the first {OD_WARM_S:g} s ({len(warm_arc)} rows): max row position "
         f"difference {d_twin:.3e} km")
    if not d_twin < TWIN_FINAL_TOL_KM:
        raise RuntimeError(f"OD flagship kernel and twin runs differ by {d_twin} km")
    _f32_vs_f64(f"OD flagship, first {OD_WARM_S:g} s,", warm,
                od("auto", "f64").process_arc(est, warm_arc))
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
    """Config 4's station-keeping Monte Carlo on the card: B_SK lanes over
    SK_SECONDS of its 30 days, after a 600 s warm-up, then B_SK_TWIN of its
    lanes over SK_TWIN_PREFIX_S through the kernel and through the twin.
    Returns the summary's numbers."""
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


def phase_config3(gp, leo, kernel64, device="cuda"):
    """Config 3 on `device` (the card; "cpu" rehearses it): ex02's scene at
    full width, over the first EX02_DAYS of its 6.5 days. (a) `predict_for`
    at 60 s (2,880 estimates), timed, the final covariance symmetric and
    PSD; (b) the 5,000-lane full-state Monte Carlo with 256 capture nodes
    after a 300 s warm-up, timed (5,000/5,000 ok, no kernel launch:
    ex02's dynamics hold no field; sample 0 the initial state; the MC over
    mapped position-sigma ratio in EX02_RATIO); (c) `to_parquet` of the
    finals and of every node, read back; (d) ex02's Encke mode (ABM, dt
    600 s, 256 nodes) on the same draws, against (b)'s finals; (e) Config
    2's Encke mode at the bench's defaults (fixed step, ABM, automatic dt)
    at B_MAIN over the arc of phase 5's 64-lane kernel run, after a first
    call that builds its reference: the kernel's launches counted from 0
    (> 0, no twin primal call on CUDA), its first 64 lanes against that
    run, and those lanes again through the twin. `leo` holds phase 4's
    `propagator(backend)`, `mvn` and `almanac`; `kernel64` phase 5's
    Results. Returns the summary's numbers."""
    import pyarrow.parquet as pq

    from nyx_tpu_torch.mc import MonteCarlo

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    scene = ex02_scene(device=device)
    seconds = EX02_DAYS * 86_400.0
    end = scene.epoch + seconds

    # (a) covariance mapping
    sync()
    t0 = time.perf_counter()
    sol = scene.scan.predict_for(scene.est0, seconds, step=60.0)
    sync()
    map_wall = time.perf_counter() - t0
    walls = scene.scan.stage_walls_s
    p_f = sol.final_covar()
    lam = np.linalg.eigvalsh(p_f)
    sig_map = np.sqrt(np.diag(p_f)[:3])
    _log(f"Config 3 ({_card_line()}), ex02 at full width:")
    _log(f"  (a) predict_for, {len(sol.y_est)} estimates over {EX02_DAYS} days: {map_wall:.3f} s, "
         f"{len(sol.y_est) / map_wall:.1f} estimates/s; s1 {walls['s1']:.3f} s "
         f"({walls['s1_iterations']} iterations), s2 {walls['s2']:.3f} s, s3 {walls['s3']:.3f} s, "
         f"s4 {walls['s4']:.3f} s; mapped position sigmas {sig_map.tolist()} km; final covariance "
         f"asymmetry {np.abs(p_f - p_f.T).max():.1e}, eigenvalues {lam.min():.3e} to {lam.max():.3e}")
    if len(sol.y_est) != round(seconds / 60.0):
        raise RuntimeError(f"Config 3 (a): {len(sol.y_est)} estimates")
    if not (np.array_equal(p_f, p_f.T) and lam.min() >= -1e-12 * lam.max() and np.isfinite(p_f).all()):
        raise RuntimeError("Config 3 (a): the mapped covariance is not symmetric PSD")

    # (b) the full-state Monte Carlo with capture
    mc = MonteCarlo(scene.mvn, seed=2024)
    warm = mc.run_until_epoch(scene.prop, scene.almanac, scene.epoch + 300.0, EX02_B,
                              n_capture=EX02_N_CAPTURE, device=device)
    if warm.n_ok != EX02_B:
        raise RuntimeError(f"Config 3 warm-up: {warm.n_ok}/{EX02_B} lanes ok")
    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    sync()
    t0 = time.perf_counter()
    res = mc.run_until_epoch(scene.prop, scene.almanac, end, EX02_B, n_capture=EX02_N_CAPTURE,
                             device=device)
    sync()
    mc_wall = time.perf_counter() - t0
    mc_launches = gp.pines_accel_cuda.launches + gp.pines_accel_torch.cuda_calls
    finals = res.y_final[:, :3]
    std = np.std(finals - finals.mean(axis=0), axis=0)
    ratio = float(np.linalg.norm(std) / np.linalg.norm(sig_map))
    _log(f"  (b) Monte Carlo, B={EX02_B}, n_capture={EX02_N_CAPTURE}: {mc_wall:.3f} s, "
         f"{res.n_ok / mc_wall:.2f} traj/s, n_ok/n_runs {res.n_ok}/{res.n_runs}, iterations "
         f"{res.iterations}, mean accepted steps {float(np.mean(res.n_accepted)):.2f}, mean rejected "
         f"{float(np.mean(res.n_rejected)):.2f}, traj_len {int(res.traj_len.min())}-"
         f"{int(res.traj_len.max())}, gravity launches {mc_launches}; MC position sigmas "
         f"{std.tolist()} km, MC/mapped ratio {ratio:.4f}")
    if res.n_ok != EX02_B or not np.isfinite(res.y_final).all():
        raise RuntimeError(f"Config 3 (b): {res.n_ok}/{EX02_B} lanes ok")
    if mc_launches != 0:
        raise RuntimeError(f"Config 3 (b): {mc_launches} gravity calls on a path without a field")
    if not (np.array_equal(res.traj_y[:, 0, :], res.y_initial) and (res.traj_t[:, 0] == 0.0).all()):
        raise RuntimeError("Config 3 (b): sample 0 is not the initial state")
    if res.traj_len.max() > EX02_N_CAPTURE:
        raise RuntimeError(f"Config 3 (b): capture saturated ({int(res.traj_len.max())} nodes)")
    if not EX02_RATIO[0] <= ratio <= EX02_RATIO[1]:
        raise RuntimeError(f"Config 3 (b): MC/mapped ratio {ratio} outside {EX02_RATIO}")

    # (c) the exports
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        f_finals = res.to_parquet(Path(tmp) / "ex02_mc.parquet")
        f_nodes = res.to_parquet(Path(tmp) / "ex02_mc_ensemble.parquet", trajectories=True,
                                 step="nodes")
        export_wall = time.perf_counter() - t0
        rows = (pq.read_metadata(f_finals).num_rows, pq.read_metadata(f_nodes).num_rows)
        mb = Path(f_nodes).stat().st_size / 1e6
        cols = pq.read_table(f_nodes, columns=["run", "epoch_rel_s", "sma"])
    _log(f"  (c) to_parquet: {export_wall:.3f} s; finals {rows[0]} rows, every node {rows[1]} rows "
         f"({mb:.1f} MB)")
    if rows != (EX02_B, int(np.sum(res.traj_len))) or not np.isfinite(cols["sma"].to_numpy()).all():
        raise RuntimeError(f"Config 3 (c): parquet rows {rows}")

    # (d) ex02's Encke mode on the same draws
    sync()
    t0 = time.perf_counter()
    enc = mc.run_until_epoch_encke(scene.prop, scene.almanac, end, EX02_B, integ="abm", dt_s=600.0,
                                   n_capture=EX02_N_CAPTURE, device=device)
    sync()
    enc_wall = time.perf_counter() - t0
    d_enc = float(np.linalg.norm(enc.y_final[:, :3] - finals, axis=1).max())
    std_gap = float(np.abs(np.std(enc.y_final[:, :3], axis=0) / np.std(finals, axis=0) - 1.0).max())
    _log(f"  (d) Encke (abm, dt 600 s, {int(enc.n_accepted[0])} steps), B={EX02_B}: {enc_wall:.3f} s "
         f"with its reference, {enc.n_ok / enc_wall:.2f} traj/s, n_ok {enc.n_ok}; finals "
         f"{d_enc:.3e} km from (b)'s, sigmas within {std_gap:.2e}; {enc.traj_y.shape[1]} nodes a run")
    if enc.n_ok != EX02_B or not np.array_equal(enc.y_initial, res.y_initial):
        raise RuntimeError(f"Config 3 (d): {enc.n_ok}/{EX02_B} ok, or other draws than (b)'s")
    if not (d_enc < ENCKE_FULL_TOL_KM and std_gap < 1e-3):
        raise RuntimeError(f"Config 3 (d): Encke {d_enc} km from the full state, sigmas {std_gap}")

    # (e) Config 2's Encke mode through the kernel
    end2, y64 = kernel64.end_epoch, kernel64.y_initial[:B_TWIN]
    mc2 = MonteCarlo(leo.mvn, seed=42)
    prop_k = leo.propagator("auto")
    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    sync()
    t0 = time.perf_counter()
    first = mc2.run_until_epoch_encke(prop_k, leo.almanac, end2, B_MAIN, integ="abm", device=device)
    sync()
    first_wall = time.perf_counter() - t0
    first_launches = gp.pines_accel_cuda.launches
    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    t0 = time.perf_counter()
    enc2 = mc2.run_until_epoch_encke(prop_k, leo.almanac, end2, B_MAIN, integ="abm", device=device)
    sync()
    enc2_wall = time.perf_counter() - t0
    launches_encke, twin_calls = gp.pines_accel_cuda.launches, gp.pines_accel_torch.cuda_calls
    span = (end2 - leo.mvn.template.epoch).to_seconds()
    d_full = float(np.linalg.norm(enc2.y_final[:B_TWIN, :3] - kernel64.y_final[:B_TWIN, :3],
                                  axis=1).max())
    t0 = time.perf_counter()
    twin = MonteCarlo(leo.mvn, seed=42).run_until_epoch_encke(
        leo.propagator("torch"), leo.almanac, end2, B_TWIN, integ="abm", device=device, _y0=y64)
    twin_wall = time.perf_counter() - t0
    d_twin = float(np.linalg.norm(twin.y_final[:, :3] - enc2.y_final[:B_TWIN, :3], axis=1).max())
    _log(f"  (e) Config 2 Encke (fixed, abm, dt {span / int(enc2.n_accepted[0]):.2f} s, "
         f"{int(enc2.n_accepted[0])} steps), B={B_MAIN} over {span:g} s: first call with its "
         f"reference {first_wall:.3f} s ({first_launches} kernel launches), timed {enc2_wall:.3f} s, "
         f"{enc2.n_ok / enc2_wall:.2f} traj/s, kernel launches {launches_encke}, twin CUDA calls "
         f"{twin_calls}; first {B_TWIN} lanes {d_full:.3e} km from phase 5's full-state kernel run; "
         f"twin rerun ({twin_wall:.1f} s) {d_twin:.3e} km from the kernel's")
    if first.n_ok != B_MAIN or enc2.n_ok != B_MAIN or twin.n_ok != B_TWIN:
        raise RuntimeError(f"Config 2 Encke: {enc2.n_ok}/{B_MAIN}, twin {twin.n_ok}/{B_TWIN} ok")
    if not np.array_equal(enc2.y_initial[:B_TWIN], y64):
        raise RuntimeError("Config 2 Encke: other draws than phase 5's")
    if launches_encke <= 0 or twin_calls != 0:
        raise RuntimeError(f"Config 2 Encke did not run through the kernel: {launches_encke} launches, "
                           f"{twin_calls} twin calls on CUDA")
    if not (d_full < ENCKE_FULL_TOL_KM and d_twin < ENCKE_TWIN_TOL_KM):
        raise RuntimeError(f"Config 2 Encke: {d_full} km from the full state, {d_twin} km from the twin")
    _log(f"Config 3 phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches_encke=launches_encke, encke_traj_per_s=enc2.n_ok / enc2_wall,
                map_estimates_per_s=len(sol.y_est) / map_wall, mc_traj_per_s=res.n_ok / mc_wall,
                ex02_encke_traj_per_s=enc.n_ok / enc_wall)


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


def _md_solve(label, fn, sync):
    """Run one targeter solve, timed; raise if it did not converge or an
    objective's error exceeds its tolerance."""
    sync()
    t0 = time.perf_counter()
    sol = fn()
    sync()
    wall = time.perf_counter() - t0
    _log(f"  {label}: {'converged' if sol.converged else 'NOT converged'} in {sol.iterations} Newton "
         f"iterations, {sol.prop_iterations} propagator iterations, {wall:.3f} s; correction "
         f"{np.array2string(sol.correction, precision=9)}, errors {np.array2string(sol.achieved_errors, precision=3)}")
    if not sol.converged:
        raise RuntimeError(f"mission design {label}: {sol}")
    return sol, wall


def _md_targeter_scenes(prop, leo, epoch, device, sync, tag,
                        names=("sma_fd", "sma_dual", "vnc", "position"), sma_orbits: float = 0.5):
    """Scene (a)'s solves (tests/test_targeting.py:80-141) through `prop`:
    sma 8,000 km `sma_orbits` of an orbit later (the reference's half) by
    FD and by dual, the VNC sma and ecc pair 2,000 s later, the apoapsis
    radius by position 1,000 s later; those in `names`. Returns {name:
    (solution, wall)}."""
    from nyx_tpu_torch.md.objective import Objective
    from nyx_tpu_torch.md.opti import Targeter

    half = epoch + leo.orbit.period_s * sma_orbits
    sma = [Objective.within_tolerance("sma", 8000.0, 1e-3)]
    scenes = {
        "sma_fd": (sma, lambda o: Targeter.delta_v(prop, o).try_achieve_fd(leo, epoch, half, device=device)),
        "sma_dual": (sma, lambda o: Targeter.delta_v(prop, o).try_achieve_dual(leo, epoch, half, device=device)),
        "vnc": ([Objective.within_tolerance("sma", 7500.0, 1e-3), Objective.within_tolerance("ecc", 0.05, 1e-6)],
                lambda o: Targeter.vnc(prop, o).try_achieve_from(leo, epoch, epoch + 2000.0, device=device)),
        "position": ([Objective.within_tolerance("apoapsis_radius", 7465.0, 1e-3)],
                     lambda o: Targeter.delta_r(prop, o).try_achieve_from(leo, epoch, epoch + 1000.0,
                                                                          device=device)),
    }
    out = {}
    for name in names:
        objectives, run = scenes[name]
        out[name] = _md_solve(f"{tag} {name}", lambda: run(objectives), sync)
        errs = out[name][0].achieved_errors
        if not all(abs(e) <= o.tolerance for e, o in zip(errs, objectives)):
            raise RuntimeError(f"mission design {tag} {name}: errors {errs} over the tolerances")
    return out


def phase_mission_design(gp, stor21, device="cuda"):
    """Mission design on `device` (the card; "cpu" rehearses it), the
    reference's own scenes at their published sizes:

    (a) the targeter from tests/test_targeting.py:80-141's LEO: sma 8,000 km
        half an orbit later by FD and by dual, the VNC pair, the position
        target; in two-body (RK89 at 1e-12), then under the 21x21 JGM3
        split field at 1e-10 through the kernel, the sma solves a quarter
        orbit later (its launches counted from 0, no twin primal call on
        CUDA), then FD's and the dual's first
        Newton iterations towards the same sma a sixteenth of an orbit
        later through the kernel and with backend="torch";
    (b) finite-burn targeting, `thrust_dir` and `thrust_dir_rate`
        (:184-262), each maneuver flown again and held to the rocket
        equation, and `convert_impulsive_mnvr` (:263-303) against the
        impulsive truth;
    (c) the 3-node minimum-fuel multiple shooting of :147-182;
    (d) the Earth -> Mars barycenter porkchop over the 2020 window at one
        day: 120 departures from 2020-06-01 by 360 arrivals from
        2020-11-01 (43,200 cells) on the analytic ephemeris, and
        test_lambert.py:118-140's 12 x 12 grid, each against a CPU run of
        `porkchop_grid` on the same inputs;
    (e) the B-plane of Davis' case (test_targeting.py:24-52), the sequence
        of test_sequence.py:26-48, and the state-carried STM over half an
        orbit of (a)'s LEO (one orbit until the tracking phase needed the
        time) under the split field against central differences of the
        same propagation.

    Returns the summary's numbers."""
    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft
    from nyx_tpu_torch.constants import GM, NAIF, STD_GRAVITY_M_S2
    from nyx_tpu_torch.cosmic.bplane import BPlane, BPlaneTarget, try_achieve_b_plane
    from nyx_tpu_torch.cosmic.spacecraft import GuidanceMode, Thruster
    from nyx_tpu_torch.dynamics import (
        DiscreteEvent, DynamicsConfig, Harmonics, LocalFrame, Maneuver, OrbitalDynamics, Phase,
        PhysicalProperties, PropagatorConfig, SpacecraftDynamics, SpacecraftSequence,
    )
    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.md.objective import Objective
    from nyx_tpu_torch.md.opti import Targeter, convert_impulsive_mnvr
    from nyx_tpu_torch.md.opti.multishoot import CostFunction, MultipleShooting, equidistant_nodes
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator, integrator
    from nyx_tpu_torch.tools import porkchop, porkchop_grid

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    eme = Frames.EME2000
    epoch = Epoch.from_gregorian_utc(*MD_EPOCH)
    _log(f"Mission design phase ({_card_line()}):")

    # (a) the targeter: two-body, split through the kernel, split through the twin
    two_body = Propagator.rk89(SpacecraftDynamics.new(OrbitalDynamics.two_body(eme)), IntegratorOptions())

    def split_prop(backend):
        field = Harmonics.from_stor(stor21, "split", backend)
        return Propagator.rk89(SpacecraftDynamics.new(OrbitalDynamics.from_model(field, eme)),
                               IntegratorOptions(tolerance=MD_SPLIT_TOL))

    leo = Spacecraft.from_orbit(Orbit.keplerian(7378.1363, 0.01, 28.5, 10.0, 5.0, 0.0, epoch, eme))
    a2b = _md_targeter_scenes(two_body, leo, epoch, device, sync, "two-body")
    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    t0 = time.perf_counter()
    # the split FD and dual solves aim a quarter orbit ahead, a depth cut
    # of the reference's half (the dual's half orbit took 61.0 s) that paid
    # for phase 6n; the two-body solves keep the half
    akern = _md_targeter_scenes(split_prop("auto"), leo, epoch, device, sync, "21x21 split, kernel",
                                sma_orbits=MD_SPLIT_SMA_ORBITS)
    split_wall = time.perf_counter() - t0
    launches, twin_calls = gp.pines_accel_cuda.launches, gp.pines_accel_torch.cuda_calls
    # the twin witnesses: the first Newton iteration of FD and of the dual
    # through the kernel and through the twin, towards the same sma a
    # sixteenth of an orbit later (8 integrator iterations; 16 from an
    # eighth to a quarter). Until phase 6m needed the time, FD's whole
    # solve ran through the twin (15.9 s) and the dual's first iteration
    # aimed a quarter orbit ahead (15.9 s for both); the dual's whole solve
    # until the tracking phase (53.7-90.8 s), half an orbit until the host
    # loop's CPU run.
    sma_obj = [Objective.within_tolerance("sma", 8000.0, 1e-3)]
    ahead = epoch + leo.orbit.period_s / 16.0
    t0 = time.perf_counter()
    first = {(m, b): Targeter.delta_v(split_prop(b), sma_obj, iterations=1).try_achieve_from(
        leo, epoch, ahead, m, device=device) for m in ("fd", "dual") for b in ("auto", "torch")}
    sync()
    d_twin = max(float(np.abs(first[(m, "auto")].correction - first[(m, "torch")].correction).max())
                 for m in ("fd", "dual"))
    _log(f"  21x21 split FD's and dual's first Newton iterations through the kernel and the twin "
         f"({time.perf_counter() - t0:.3f} s): corrections {d_twin:.3e} km/s apart")
    fd, dual = a2b["sma_fd"][0].correction, a2b["sma_dual"][0].correction
    d_dual = float(np.abs(fd - dual).max())
    fd, dual = akern["sma_fd"][0].correction, akern["sma_dual"][0].correction
    d_dual_split = abs(float(np.linalg.norm(fd) - np.linalg.norm(dual)))
    solves = len(a2b) + len(akern)  # the witnesses' single iterations not counted
    _log(f"  (a) Pines launches on the split solves {launches}, twin primal calls on CUDA {twin_calls}; "
         f"split {split_wall:.3f} s for {len(akern)} solves; kernel vs twin (FD's and the dual's first "
         f"iterations): corrections within {d_twin:.3e} km/s; dual vs FD {d_dual:.3e} km/s "
         f"(two-body); split: magnitudes {d_dual_split:.3e} km/s apart, components "
         f"{float(np.abs(fd - dual).max()):.3e}")
    if launches <= 0 or twin_calls != 0:
        raise RuntimeError(f"mission design (a): {launches} kernel launches, {twin_calls} twin calls on CUDA")
    if not d_twin < MD_TWIN_TOL_KM_S:
        raise RuntimeError(f"mission design (a): kernel vs twin {d_twin} km/s")
    if not (d_dual < MD_DUAL_FD_KM_S and d_dual_split < MD_DUAL_FD_KM_S):
        raise RuntimeError(f"mission design (a): dual vs FD {d_dual} km/s (two-body), {d_dual_split} (split)")

    walls = {"a": time.perf_counter() - t_phase}
    t_part = time.perf_counter()

    # (b) finite burns: thrust_dir, thrust_dir_rate, then the impulsive conversion
    thruster = Thruster(thrust_N=400.0, isp_s=300.0)
    mdot = thruster.thrust_N / (thruster.isp_s * STD_GRAVITY_M_S2)
    sc = dataclasses.replace(Spacecraft.new(Orbit.keplerian(7000.0, 0.001, 28.5, 0.0, 0.0, 0.0, epoch, eme),
                                            900.0, 100.0, 0.0, 0.0, 1.8, 2.2), thruster=thruster)
    a0 = sc.orbit.sma_km
    mnvr0 = Maneuver.from_time_invariant(epoch, epoch + 300.0, 1.0, [1.0, 0.0, 0.0], LocalFrame.VNC)
    achieve = epoch + 3000.0

    def fly(start_sc, mnvr, until):
        """The maneuver flown as a plain law, then the coast to `until`:
        (state at the burn's end, state at `until`)."""
        pre = start_sc if start_sc.epoch == mnvr.start else \
            two_body.with_state(start_sc, device=device).until_epoch(mnvr.start)
        post = two_body.with_guidance(mnvr).with_state(dataclasses.replace(pre, mode=GuidanceMode.Thrust),
                                                       device=device).until_epoch(mnvr.end)
        fin = two_body.with_state(dataclasses.replace(post, mode=GuidanceMode.Coast),
                                  device=device).until_epoch(until)
        d_mass = abs((pre.prop_mass_kg - post.prop_mass_kg) - mnvr.thrust_prct * mdot * mnvr.duration_s)
        return post, fin, d_mass

    finite = {
        "thrust_dir": ([Objective("sma", a0 + 150.0, 0.5)], Targeter.thrust_dir),
        "thrust_dir_rate": ([Objective("sma", a0 + 120.0, 0.5), Objective("inc", 28.55, 5e-4)],
                            Targeter.thrust_dir_rate),
    }
    d_rocket = 0.0
    for name, (objectives, make) in finite.items():
        sol, _ = _md_solve(name, lambda: make(two_body, objectives, mnvr0).try_achieve_from(
            sc, epoch, achieve, device=device), sync)
        solves += 1
        mnvr = sol.to_mnvr()
        _, fin, d_mass = fly(sc, mnvr, achieve)
        d_rocket = max(d_rocket, d_mass)
        d_sma = abs(fin.orbit.sma_km - objectives[0].desired_value)
        _log(f"  {name} flown: {mnvr}; sma {d_sma:.3e} km from its target, rocket equation {d_mass:.3e} kg")
        if not (0.0 < mnvr.thrust_prct <= 1.0 and d_sma < 1.0 and d_mass < MD_ROCKET_KG):
            raise RuntimeError(f"mission design (b) {name}: {mnvr}, sma off {d_sma} km, mass off {d_mass} kg")
    sc1 = dataclasses.replace(sc, orbit=Orbit.keplerian(7000.0, 0.001, 28.5, 0.0, 0.0, 0.0, epoch + 3600.0, eme))
    dv = 0.025 * sc1.orbit.v_km_s / np.linalg.norm(sc1.orbit.v_km_s)  # 25 m/s prograde
    sol, _ = _md_solve("convert_impulsive_mnvr", lambda: convert_impulsive_mnvr(sc1, dv, two_body, device=device),
                       sync)
    solves += 1
    mnvr = sol.to_mnvr()
    truth = two_body.with_state(sc1.with_dv(dv), device=device).until_epoch(mnvr.end + 900.0)
    _, fin, d_mass = fly(sc1, mnvr, mnvr.end + 900.0)
    d_rocket = max(d_rocket, d_mass)
    err_r = float(np.linalg.norm(fin.orbit.r_km - truth.orbit.r_km))
    err_v = float(np.linalg.norm(fin.orbit.v_km_s - truth.orbit.v_km_s))
    _log(f"  convert_impulsive_mnvr flown: {mnvr}; {err_r:.3e} km, {err_v:.3e} km/s from the impulsive truth, "
         f"rocket equation {d_mass:.3e} kg")
    if not (50.0 < mnvr.duration_s < 80.0 and err_r < MD_CONVERT_KM and err_v < MD_CONVERT_KM_S
            and d_mass < MD_ROCKET_KG):
        raise RuntimeError(f"mission design (b) conversion: {mnvr}, {err_r} km, {err_v} km/s, {d_mass} kg")

    walls["b"] = time.perf_counter() - t_part

    # (c) multiple shooting
    x0 = Spacecraft.from_orbit(Orbit.keplerian(7378.0, 0.01, 28.5, 0.0, 0.0, 0.0, epoch, eme))
    xf = Orbit.keplerian(7900.0, 0.01, 28.5, 0.0, 0.0, 25.0, epoch + 450.0, eme)
    sync()
    t0 = time.perf_counter()
    ms = MultipleShooting(two_body, x0, xf, equidistant_nodes(x0, xf, 3, tolerance_km=1e-3))
    msol = ms.solve(CostFunction.MinimumFuel, device=device)
    sync()
    ms_wall = time.perf_counter() - t0
    d_nodes = max(float(np.linalg.norm(seg.achieved_state.orbit.r_km - node.position()))
                  for node, seg in zip(msol.nodes, msol.solutions))
    d_end = float(np.linalg.norm(msol.nodes[-1].position() - xf.r_km))
    solves += msol.solves
    _log(f"  (c) {msol}: {ms_wall:.3f} s, {msol.solves} segment solves, {msol.newton_iterations} Newton "
         f"iterations, {msol.prop_iterations} propagator iterations; nodes hit within {d_nodes:.3e} km")
    if not (len(msol.solutions) == 3 and all(s.converged for s in msol.solutions)
            and msol.total_dv_km_s() < MD_MS_DV_KM_S and d_nodes < MD_MS_NODE_KM and d_end < 1e-9):
        raise RuntimeError(f"mission design (c): {msol}, nodes {d_nodes} km, end node {d_end} km")

    # (d) porkchops
    t_part = time.perf_counter()
    alm = Almanac()

    def grid(dep0, n_dep, dep_days, arr0, n_arr, arr_days, label):
        deps = [Epoch.from_gregorian_utc(*dep0) + k * dep_days * 86_400.0 for k in range(n_dep)]
        arrs = [Epoch.from_gregorian_utc(*arr0) + k * arr_days * 86_400.0 for k in range(n_arr)]
        sync()
        t0 = time.perf_counter()
        pc = porkchop(alm, NAIF.EARTH, NAIF.MARS_BARYCENTER, deps, arrs, device=device)
        sync()
        wall = time.perf_counter() - t0
        # the grid solve alone, on the same inputs, on the device and on the CPU
        rv = {b: [alm.state(b, NAIF.SUN, e) for e in es]
              for b, es in ((NAIF.EARTH, deps), (NAIF.MARS_BARYCENTER, arrs))}
        r1 = np.repeat(np.stack([r for r, _ in rv[NAIF.EARTH]]), n_arr, axis=0)
        v1 = np.repeat(np.stack([v for _, v in rv[NAIF.EARTH]]), n_arr, axis=0)
        r2 = np.tile(np.stack([r for r, _ in rv[NAIF.MARS_BARYCENTER]]), (n_dep, 1))
        v2 = np.tile(np.stack([v for _, v in rv[NAIF.MARS_BARYCENTER]]), (n_dep, 1))
        t_dep = np.array([e.to_tdb_seconds() for e in deps])
        tof = (np.array([e.to_tdb_seconds() for e in arrs])[None, :] - t_dep[:, None]).ravel()
        cells = n_dep * n_arr

        def solve(dev, scale=1.0):
            args = [torch.as_tensor(a, dtype=torch.float64, device=dev) for a in (r1 * scale, v1, r2, v2, tof)]
            return [t.cpu().numpy() for t in porkchop_grid(*args, GM.SUN)]

        solve(device)
        sync()
        t0 = time.perf_counter()
        on_dev = solve(device)
        sync()
        grid_wall = time.perf_counter() - t0
        on_cpu = solve("cpu")
        # each cell's own rounding sensitivity: its relative change on the CPU
        # when the departure positions move by MD_PORKCHOP_EPS relative
        sens = np.zeros(cells)
        for scale in (1.0 + MD_PORKCHOP_EPS, 1.0 - MD_PORKCHOP_EPS):
            for a, b in zip(solve("cpu", scale), on_cpu):
                sens = np.maximum(sens, np.nan_to_num(np.abs(a - b) / np.abs(b)))
        bound = np.maximum(MD_PORKCHOP_REL, MD_PORKCHOP_SENS * sens)
        d_rel, same_nan, n_over, n_ill = 0.0, True, 0, int((bound > MD_PORKCHOP_REL).sum())
        for a, b in zip(on_dev, on_cpu):
            same_nan &= bool(np.array_equal(np.isnan(a), np.isnan(b)))
            ok = np.isfinite(b)
            rel = np.abs(a[ok] - b[ok]) / np.abs(b[ok])
            d_rel, n_over = max(d_rel, float(rel.max())), n_over + int((rel > bound[ok]).sum())
        same_call = np.array_equal(pc.c3_km2_s2.ravel(), on_dev[0], equal_nan=True)
        dep, arr, c3min = pc.best("c3_km2_s2")
        _log(f"  (d) {label}: {cells} cells, porkchop() {wall:.3f} s; the grid solve {grid_wall * 1e3:.3f} ms, "
             f"{cells / grid_wall:.4g} cells/s; against the CPU: {d_rel:.3e} relative at most, {n_over} cells over "
             f"their bound ({n_ill} ill-conditioned), same NaN cells "
             f"{same_nan} ({int(np.isnan(on_cpu[0]).sum())}); min C3 {c3min:.4f} km^2/s^2 departing {dep}, "
             f"arriving {arr}")
        if not (n_over == 0 and same_nan and same_call and MD_C3[0] < c3min < MD_C3[1]
                and dep.to_tai_seconds() > Epoch.from_gregorian_utc(2020, 7, 1).to_tai_seconds()
                and np.nanmin(pc.vinf_arrival_km_s) > 1.0):
            raise RuntimeError(f"mission design (d) {label}: {d_rel} relative, NaN cells same {same_nan}, "
                               f"min C3 {c3min} departing {dep}")
        return cells / grid_wall

    cells_per_s = grid((2020, 6, 1), 120, 1, (2020, 11, 1), 360, 1, "2020 window at one day")
    grid((2020, 6, 20), 12, 5, (2020, 12, 1), 12, 10, "test_lambert.py's 12 x 12 grid")

    walls["c"], walls["d"] = ms_wall, time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (e) the B-plane, the sequence, the state-carried STM
    davis = Orbit.cartesian(546507.344255845, -527978.380486028, 531109.066836708, -4.9220589268733,
                            5.36316523097915, -5.22166308425181, Epoch.from_gregorian_utc(2016, 1, 1), eme)
    bp = BPlane.from_orbit(davis)
    dv_b, achieved = try_achieve_b_plane(davis, BPlaneTarget.from_bt_br(13135.7982982557, 5022.26511510685))
    d_dv = float(np.abs(dv_b - np.array(DAVIS_DV)).max())
    _log(f"  (e) Davis' B-plane: B.T {bp.b_t_km:.6f} km, B.R {bp.b_r_km:.6f} km; targeting delta-v "
         f"{d_dv:.3e} km/s from the reference's")
    if not (abs(bp.b_t_km - 45892.323790) < 1e-4 and abs(bp.b_r_km - 10606.210428) < 1e-4 and d_dv < 1e-9):
        raise RuntimeError(f"mission design (e) B-plane: {bp}, delta-v {d_dv}")

    t1, t2 = epoch + 1800.0, epoch + 2400.0
    burn = Maneuver.from_time_invariant(t1, t2, 1.0, [1.0, 0.0, 0.0], LocalFrame.VNC)
    seq = SpacecraftSequence(
        seq={
            epoch: Phase.Activity("coast", "two_body"),
            t1: Phase.Activity("burn", "two_body", guidance={"law": burn, "thruster_model": "main"},
                               on_entry=DiscreteEvent("staging", properties=PhysicalProperties(dry_mass_kg=20.0))),
            t2: Phase.Activity("coast2", "two_body"),
            epoch + 3000.0: Phase.Terminate(),
        },
        thruster_sets={"main": Thruster(thrust_N=50.0, isp_s=300.0)},
        propagators={"two_body": PropagatorConfig(DynamicsConfig(frame=eme))},
    )
    sc_seq = Spacecraft(Orbit.keplerian(8000.0, 0.01, 30.0, 0, 0, 0, epoch, eme), dry_mass_kg=120.0,
                        prop_mass_kg=80.0)
    trajs = seq.propagate(sc_seq, device=device)
    burned = trajs[1].first.prop_mass_kg - trajs[1].last.prop_mass_kg
    d_burn = abs(burned - 50.0 / (300.0 * STD_GRAVITY_M_S2) * 600.0)
    _log(f"  (e) sequence: {len(trajs)} phases, dry mass at the burn {trajs[1].first.dry_mass_kg:.6f} kg, "
         f"burned {burned:.9f} kg ({d_burn:.3e} kg from the rocket equation), final {trajs[2].last.epoch}")
    if not (len(trajs) == 3 and abs(trajs[1].first.dry_mass_kg - 100.0) < 1e-12 and d_burn < 1e-6
            and abs(trajs[2].last.prop_mass_kg - trajs[1].last.prop_mass_kg) < 1e-12
            and trajs[2].last.orbit.energy_km2_s2 > sc_seq.orbit.energy_km2_s2
            and abs((trajs[2].last.epoch - epoch).to_seconds() - 3000.0) < 1e-6):
        raise RuntimeError("mission design (e): the sequence's masses, energy or timeline are off")

    prop = split_prop("auto")
    period = leo.orbit.period_s / 2.0
    gp.pines_accel_cuda.launches = 0
    sync()
    t0 = time.perf_counter()
    inst = prop.with_state(leo.with_stm(), device=device)
    phi = inst.for_duration(period).stm
    sync()
    stm_wall = time.perf_counter() - t0
    stm_launches = gp.pines_accel_cuda.launches
    # central differences of the same propagation, the 12 perturbed lanes one batch
    dyn = prop.dynamics
    y = leo.to_vector()
    steps = np.array([MD_CD_KM] * 3 + [MD_CD_KM_S] * 3)
    rows = [y + s * h * np.eye(9)[j] for j in range(6) for s, h in ((1.0, steps[j]), (-1.0, steps[j]))]
    res = integrator.propagate(dyn.make_eom(), torch.as_tensor(np.stack(rows), device=device), period, prop.opts,
                               prop.method, finally_fn=dyn.make_finally(),
                               eom_args=(dyn.build_context(epoch, period, None, device=device),
                                         dict(dry_mass_kg=0.0, srp_area_m2=0.0, drag_area_m2=0.0)))
    yf = res.y.cpu().numpy()
    jac = np.stack([(yf[2 * j] - yf[2 * j + 1]) / (2 * steps[j]) for j in range(6)], axis=1)[:6]
    block = phi[:6, :6]
    big = np.abs(block) >= MD_STM_BIG * np.abs(block).max()
    d_stm = float((np.abs(block - jac)[big] / np.abs(block)[big]).max())
    _log(f"  (e) STM over half an orbit ({period:.1f} s) under the split field: {stm_wall:.3f} s, "
         f"{inst.last_result.iterations} iterations, Pines launches {stm_launches}; against central "
         f"differences {d_stm:.3e} relative on the {int(big.sum())} entries of at least {MD_STM_BIG:g} of the "
         f"largest ({np.abs(block).max():.4g})")
    if not (d_stm < MD_STM_REL and np.array_equal(phi[6:, 6:], np.eye(3)) and stm_launches > 0):
        raise RuntimeError(f"mission design (e): STM {d_stm} relative from central differences")

    walls["e"] = time.perf_counter() - t_part
    wall = time.perf_counter() - t_phase
    _log(f"  walls: " + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items()))
    _log(f"Mission design phase: {wall:.1f} s, {solves} targeter solves ({solves / wall:.3f} a second)")
    return dict(launches=launches, porkchop_cells_per_s=cells_per_s, solves=solves, wall=wall)


def phase_tracking_od(gp, device="cuda"):
    """The tracking side of OD on `device` (the card; "cpu" rehearses it):
    (a) ex05's crosslink OD (`ex05_flow`) over its 2 h: stage walls, then
    the guards: the port's CPU counts (EX05_CPU_*), its final error within
    EX05_CPU_TOL_M of the CPU's and within EX05_REFERENCE_TOL_M of the
    reference's artifact, the residual-versus-reference run accepting
    nothing, the three parquets read back, no Pines launch (point masses
    only); (b) ex06's OD (`ex06_scene`, the 50x50 field at split precision)
    over its first EX06_HOURS: the truth, timed, with its kernel launches;
    the stations' and tracking YAML written and read back; the arc; the
    zero-noise cross-body CKF from the truth over the arc's first
    EX06_CKF_S (range prefits under EX06_PREFIT_KM); the EKF from the dispersed start, timed, with its
    kernel launches (no twin primal call on CUDA), its final error under
    half the initial one, range postfit RMS and mean NIS; and the truth's
    first EX06_TWIN_PREFIX_S through the kernel and the twin (within
    1e-9 km). The parquets and YAML go to a temporary directory, removed
    after. Returns the summary's numbers."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_6i_") as tmp:
        return _tracking_od(gp, device, Path(tmp))


def _tracking_od(gp, device, out_dir):
    import pyarrow.parquet as pq

    from nyx_tpu_torch import Epoch
    from nyx_tpu_torch.od import MeasurementType, TrackingArcSim, TrackingDataArc

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def reset():
        gp.pines_accel_cuda.launches = 0
        gp.pines_accel_torch.cuda_calls = 0

    t_phase = time.perf_counter()
    card = _card_line()

    # (a) ex05
    reset()
    ex = ex05_flow(EX05_HOURS, device=device, out_dir=out_dir)
    ex05_launches = gp.pines_accel_cuda.launches
    rows, acc = len(ex.arc_2h), ex.sol.accepted
    rej = int(np.sum(ex.sol.rejected))
    ex05_rate = rows / ex.walls["od"]
    truth_ms = 1e3 * (ex.walls["tx truth"] + ex.walls["llo truth"]) / ex.iterations
    _log(f"Tracking phase ({card}), (a) ex05 over {EX05_HOURS:g} h of its 12 h truths:")
    _log("  walls: " + ", ".join(f"{k} {v:.3f} s" for k, v in ex.walls.items()) + f"; truths "
         f"{ex.iterations} integrator iterations, {truth_ms:.3f} ms an iteration")
    _log(f"  {len(ex.arc)} crosslink measurements, {rows} in the OD's {EX05_OD_S:g} s: {acc} accepted, {rej} "
         f"rejected, {ex05_rate:.2f} rows/s; segments {ex.od_walls['segments']}, s1 iterations "
         f"{ex.od_walls['s1_iterations']}; " + ", ".join(f"{k} {ex.od_walls[k]:.3f} s" for k in ("s1", "s2", "s3", "s4")))
    _log(f"  initial error {ex.init_err_m:.1f} m; final error {ex.err_m:.4f} m (RIC "
         f"{np.array2string(ex.err_ric_m, precision=2)} m; the port's CPU run {EX05_CPU_ERROR_M:.4f} m, the "
         f"reference's {EX05_REFERENCE_ERROR_M} m); pure propagation {ex.prop_err_m:.1f} m, "
         f"{ex.rvr.accepted} accepted; Pines launches {ex05_launches}")
    back = TrackingDataArc.from_parquet(ex.paths[0])
    tables_ok = (np.array_equal(back.epochs_tai_s, ex.arc.epochs_tai_s)
                 and np.array_equal(back.values, ex.arc.values, equal_nan=True)
                 and all(pq.read_table(str(p)).num_rows == rows for p in ex.paths[1:]))
    if (rows, acc, rej) != (EX05_CPU_ROWS, EX05_CPU_ACCEPTED, EX05_CPU_ROWS - EX05_CPU_ACCEPTED):
        raise RuntimeError(f"ex05: {rows} rows, {acc} accepted, {rej} rejected; the CPU run gave "
                           f"{EX05_CPU_ROWS}, {EX05_CPU_ACCEPTED}")
    if not (abs(ex.err_m - EX05_CPU_ERROR_M) < EX05_CPU_TOL_M
            and abs(ex.err_m - EX05_REFERENCE_ERROR_M) < EX05_REFERENCE_TOL_M):
        raise RuntimeError(f"ex05: final error {ex.err_m} m")
    if ex.rvr.accepted != 0 or not tables_ok or ex05_launches != 0:
        raise RuntimeError(f"ex05: resid-vs-ref accepted {ex.rvr.accepted}, parquets read back {tables_ok}, "
                           f"{ex05_launches} Pines launches")

    # (b) ex06
    seconds = EX06_HOURS * 3600.0
    scene = ex06_scene(ex06_moon_field(EX06_DEGREE), "split", yaml_dir=out_dir, device=device)
    prop, alm = scene.propagator("auto"), scene.almanac
    prop.with_state(scene.orbiter, alm, device=device).for_duration(60.0)  # warm-up: caches and allocator
    reset()
    inst = prop.with_state(scene.orbiter, alm, device=device)
    sync()
    t0 = time.perf_counter()
    _, traj = inst.for_duration_with_traj(seconds)
    sync()
    truth_wall = time.perf_counter() - t0
    truth_launches, truth_twin = gp.pines_accel_cuda.launches, gp.pines_accel_torch.cuda_calls
    res = inst.last_result
    ex06_ms = 1e3 * truth_wall / res.iterations
    _log(f"Tracking phase, (b) ex06 ({EX06_DEGREE}x{EX06_DEGREE} split, Earth, Sun and Jupiter, SRP) over "
         f"{EX06_HOURS:g} h of its 2 days: truth wall {truth_wall:.3f} s, {len(traj)} nodes, integrator "
         f"iterations {res.iterations}, {ex06_ms:.3f} ms an iteration; Pines launches {truth_launches}, twin "
         f"calls on CUDA {truth_twin}")
    if not np.isfinite(traj.ys).all() or traj.ts[-1] != seconds:
        raise RuntimeError("ex06 truth: nodes are not finite or the arc is short")
    stations = scene.stations(scene.epoch, scene.epoch + seconds)
    t0 = time.perf_counter()
    arc = TrackingArcSim.with_seed(stations, traj, scene.configs, seed=123, device=device).generate_measurements()
    arc0 = TrackingArcSim.with_seed([g.perfect() for g in stations], traj, scene.configs, seed=123,
                                    device=device).generate_measurements()
    sim_wall = time.perf_counter() - t0
    per = {n: int(np.sum(arc.tracker_idx == i)) for i, n in enumerate(arc.trackers)}
    _log(f"  stations {', '.join(scene.devices)} from the YAML, each with_target_frame(MOON); {len(arc)} rows "
         f"{per} and the zero-noise arc, simulated in {sim_wall:.3f} s")

    # the zero-noise CKF from the truth
    reset()
    t0 = time.perf_counter()
    sol0 = scene.od(stations, "auto", "ckf").process_arc(scene.unc.to_estimate(), _head(arc0, EX06_CKF_S))
    sync()
    ckf_wall = time.perf_counter() - t0
    prefit_km = float(np.abs(sol0.prefit[:, 0]).max())
    ckf_launches, ckf_twin = gp.pines_accel_cuda.launches, gp.pines_accel_torch.cuda_calls
    _log(f"  zero-noise cross-body CKF from the truth over the first {EX06_CKF_S:g} s: {ckf_wall:.3f} s, range prefits within {prefit_km:.3e} km; "
         f"Pines launches {ckf_launches}, twin calls on CUDA {ckf_twin}")

    # the EKF, timed
    od = scene.od(stations)
    reset()
    sync()
    t0 = time.perf_counter()
    sol = od.process_arc(scene.est0, arc)
    sync()
    wall = time.perf_counter() - t0
    launches, twin_calls = gp.pines_accel_cuda.launches, gp.pines_accel_torch.cuda_calls
    w = od.stage_walls_s
    ex06_rate = len(arc) / wall
    truth_fin = traj.at(Epoch.from_tai_seconds_j2000(float(sol.epochs_tai_s[-1]))).to_vector()
    err_km = float(np.linalg.norm(sol.final_state()[:3] - truth_fin[:3]))
    init_km = float(np.linalg.norm(scene.dispersed.orbit.r_km - scene.orbit.r_km))
    accepted = ~np.asarray(sol.rejected)
    ridx = sol.types.index(MeasurementType.RANGE_KM)
    rms_km = float(np.sqrt(np.mean(sol.postfit[accepted, ridx] ** 2)))
    nis = float(np.mean(sol.ratio[accepted] ** 2))
    _log(f"  EKF (segment_rows {EX06_SEGMENT_ROWS}, SNC, 3-sigma gate, stm_jvp_degree 8), timed process_arc: rows {len(arc)}, "
         f"segments {w['segments']}, s1 iterations {w['s1_iterations']}; wall {wall:.3f} s, {ex06_rate:.2f} "
         f"rows/s; " + ", ".join(f"{k} {w[k]:.3f} s" for k in ("s1", "s2", "s3", "s4")))
    _log(f"  Pines launches {launches}, twin primal calls on CUDA {twin_calls}; {sol.accepted} accepted; final "
         f"error {err_km * 1e3:.3f} m from an initial {init_km * 1e3:.1f} m; range postfit RMS "
         f"{rms_km * 1e3:.3f} m; mean NIS {nis:.3f}")
    if truth_launches <= 0 or launches <= 0 or truth_twin or ckf_twin or twin_calls:
        raise RuntimeError(f"ex06 did not run through the kernel: {truth_launches} and {launches} launches, "
                           f"{truth_twin}, {ckf_twin} and {twin_calls} twin calls on CUDA")
    if not prefit_km < EX06_PREFIT_KM:
        raise RuntimeError(f"ex06 zero-noise CKF: range prefit {prefit_km} km")
    if sol.y_est.shape != (len(arc), 9) or not np.isfinite(sol.y_est).all() or not err_km < 0.5 * init_km:
        raise RuntimeError(f"ex06 EKF: final error {err_km * 1e3:.1f} m from an initial {init_km * 1e3:.1f} m")

    # the twin witness over the truth's first EX06_TWIN_PREFIX_S
    finals = {b: scene.propagator(b).with_state(scene.orbiter, alm, device=device).for_duration(
        EX06_TWIN_PREFIX_S).orbit.r_km for b in ("auto", "torch")}
    d_twin = float(np.linalg.norm(finals["auto"] - finals["torch"]))
    _log(f"  twin witness over the first {EX06_TWIN_PREFIX_S:g} s: final positions {d_twin:.3e} km apart")
    if not d_twin < 1e-9:
        raise RuntimeError(f"ex06: kernel and twin truths differ by {d_twin} km")
    _log(f"Tracking phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(ex05_rows_per_s=ex05_rate, ex06_rows_per_s=ex06_rate, launches_ex06=launches,
                launches_ex06_truth=truth_launches, ex06_truth_ms_per_iter=ex06_ms, scene=scene,
                stations=stations, arc=arc, sol=sol, traj=traj)


def ex03_scenes(stor21, stor8, stor4):
    """examples/03_geo_analysis.py through the port's own names: (a) the
    drift bench (:54-116), 2,000 kg at GEO (42,164 km, 0.05 deg,
    2024-03-01) with 16 m^2 of SRP and drag area, the 21x21 field at split
    precision, Sun and Moon point masses and SRP with the Earth's and the
    Moon's shadows, RK89 at 1e-9 (0.1-2,700 s); (b) the GTO raise
    (:119-212), 1,000 kg dry and 1,000 kg of propellant on a 24,505.9 km,
    e 0.725, 7.05 deg orbit, a 0.472 N / 4,435 s thruster under
    `Ruggiero.from_max_eclipse(..., 0.2)` toward GEO, the 8x8 field at f64,
    Moon and Sun, SRP with the Earth's shadow, RK89 at 1e-8 (1-600 s); (d)
    raise_optim (:353-530), the same spacecraft toward 30,000 km under
    `Ruggiero.from_ctx_thresholds` (each lane's thresholds from
    `guidance_params`), the 4x4 field at f64, RK89 at 1e-8 (10-2,700 s),
    and its first population (rng 7, [P, 3] in [0.1, 1]). The example's
    TPU knobs (loop_mode="scan", scan_iterations, NYX_MIN_LANES) have no
    counterpart in the port. Returns a namespace."""
    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft
    from nyx_tpu_torch.constants import NAIF
    from nyx_tpu_torch.cosmic.spacecraft import GuidanceMode, Thruster
    from nyx_tpu_torch.dynamics import (
        Harmonics, OrbitalDynamics, PointMasses, Ruggiero, SolarPressure, SpacecraftDynamics,
    )
    from nyx_tpu_torch.md.objective import Objective
    from nyx_tpu_torch.md.param import StateParameter
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    eme = Frames.EME2000
    drift_epoch = Epoch.from_gregorian_utc(2024, 3, 1)
    drift_sc = Spacecraft.new(Orbit.keplerian(42_164.0, 1e-4, 0.05, 90.0, 10.0, 0.0, drift_epoch, eme),
                              2000.0, 0.0, 16.0, 16.0, 1.8, 2.2)

    def drift_propagator(backend="auto"):
        dyn = SpacecraftDynamics(
            OrbitalDynamics.from_models((Harmonics.from_stor(stor21, precision="split", backend=backend),
                                         PointMasses((NAIF.SUN, NAIF.MOON))), eme),
            (SolarPressure((NAIF.EARTH, NAIF.MOON)),))
        return Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9))

    epoch = Epoch.from_gregorian_utc(2024, 2, 29, 12, 13, 14)
    gto = Spacecraft.from_thruster(Orbit.keplerian(24_505.9, 0.725, 7.05, 0.0, 0.0, 0.0, epoch, eme),
                                   dry_mass_kg=1000.0, prop_mass_kg=1000.0,
                                   thruster=Thruster(thrust_N=0.472, isp_s=4435.0),
                                   mode=GuidanceMode.Thrust).with_srp(18.0, 1.8)

    def objectives(sma_km):
        return [Objective.within_tolerance(StateParameter.SMA, sma_km, 20.0),
                Objective.within_tolerance(StateParameter.ECC, 0.001, 5e-5),
                Objective.within_tolerance(StateParameter.INC, 0.05, 1e-2)]

    raise_law = Ruggiero.from_max_eclipse(objectives(42_165.0), gto, 0.2)
    raise_prop = Propagator.rk89(
        SpacecraftDynamics(OrbitalDynamics.from_models((Harmonics.from_stor(stor8),
                                                        PointMasses((NAIF.MOON, NAIF.SUN))), eme),
                           (SolarPressure((NAIF.EARTH,)),), raise_law),
        IntegratorOptions.with_adaptive_step(1.0, 600.0, 1e-8))
    optim_objectives = objectives(30_000.0)
    optim_law = Ruggiero.from_ctx_thresholds(optim_objectives, gto)
    optim_prop = Propagator.rk89(
        SpacecraftDynamics(OrbitalDynamics.from_models((Harmonics.from_stor(stor4),
                                                        PointMasses((NAIF.MOON, NAIF.SUN))), eme),
                           (SolarPressure((NAIF.EARTH,)),), optim_law),
        IntegratorOptions.with_adaptive_step(10.0, 2700.0, 1e-8))
    population = np.random.default_rng(7).uniform(0.1, 1.0, size=(EX03_OPTIM_P, 3))
    return SimpleNamespace(drift_sc=drift_sc, drift_propagator=drift_propagator, gto=gto, raise_prop=raise_prop,
                           optim_prop=optim_prop, optim_objectives=optim_objectives, population=population,
                           epoch=epoch)


def phase_geo_ex03(gp, stor21, stor8, stor4, device="cuda"):
    """Phase 6j, ex03's remainder on `device` (the card; "cpu" rehearses
    it, the twin standing for the kernel): (a) the drift bench, a 600 s
    warm-up, then one day at B = 1, timed, through the kernel (launches
    counted, no twin primal call on CUDA), in propagated days a wall
    minute beside the reference's 560, and the warm-up again through the
    twin (within 1e-9 km); (b) the GTO raise over its first
    6 h at B = 1, timed (its f64 field runs no kernel, as the reference
    sends only float32 evaluations to Pallas), held to the port's CPU run:
    its final state, and the signs of its changes of sma, eccentricity and
    propellant; (c) the eclipse scan, a
    two-body day from (b)'s end, `ShadowModel((EARTH,)).percentages` every
    300 s and `find_eclipse_events`, each against the CPU on the same
    trajectory; (d) raise_optim's first generation, P lanes with their
    own thresholds over 6 h, every lane finished, two lanes rerun alone
    with their thresholds. Returns the summary's numbers."""
    from nyx_tpu_torch.constants import NAIF
    from nyx_tpu_torch.cosmic.eclipse import ShadowModel
    from nyx_tpu_torch.dynamics import OrbitalDynamics, SpacecraftDynamics
    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.mc import MonteCarlo, MvnSpacecraft, StateDispersion
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    t_phase = time.perf_counter()
    sc = ex03_scenes(stor21, stor8, stor4)
    alm = Almanac()
    walls = {}

    def reset():
        gp.pines_accel_cuda.launches = 0
        gp.pines_accel_torch.cuda_calls = 0

    # (a) the drift bench
    prop = sc.drift_propagator()
    warm = prop.with_state(sc.drift_sc, alm, device=device).for_duration(EX03_DRIFT_WARM_S)
    inst = prop.with_state(sc.drift_sc, alm, device=device)
    reset()
    _sync(device)
    t0 = time.perf_counter()
    final = inst.for_duration(EX03_DRIFT_DAYS * 86_400.0)
    _sync(device)
    wall = time.perf_counter() - t0
    launches, twin_calls = gp.pines_accel_cuda.launches, gp.pines_accel_torch.cuda_calls
    iters = inst.last_result.iterations
    days_per_min = EX03_DRIFT_DAYS / (wall / 60.0)
    walls["a"] = time.perf_counter() - t_phase
    _log(f"ex03 phase ({_card_line()}), (a) the GEO drift bench (21x21 split, Sun and Moon, SRP with the "
         f"Earth's and the Moon's shadows, RK89 at 1e-9, B = 1) over {EX03_DRIFT_DAYS:g} day of the published "
         f"1,095: wall {wall:.3f} s, {days_per_min:.3f} propagated days a minute (the reference's "
         f"{EX03_DRIFT_REFERENCE_DAYS_PER_MIN:g}), integrator iterations {iters}, {1e3 * wall / iters:.3f} ms an "
         f"iteration; Pines launches {launches}, twin primal calls on CUDA {twin_calls}; final sma "
         f"{final.orbit.sma_km:.3f} km, ecc {final.orbit.ecc:.6f}")
    if launches <= 0 or twin_calls != 0 or not np.isfinite(final.to_vector()).all():
        raise RuntimeError(f"ex03 drift bench: {launches} kernel launches, {twin_calls} twin calls on CUDA")
    twin = sc.drift_propagator("torch").with_state(sc.drift_sc, alm, device=device).for_duration(EX03_DRIFT_WARM_S)
    d_twin = float(np.linalg.norm(warm.orbit.r_km - twin.orbit.r_km))
    _log(f"      twin witness over the warm-up's {EX03_DRIFT_WARM_S:g} s: final positions {d_twin:.3e} km apart")
    if not d_twin < 1e-9:
        raise RuntimeError(f"ex03 drift bench: kernel and twin {d_twin} km apart")

    # (b) the GTO raise
    t_part = time.perf_counter()
    inst = sc.raise_prop.with_state(sc.gto, alm, device=device)
    reset()
    _sync(device)
    t0 = time.perf_counter()
    raised = inst.for_duration(EX03_RAISE_S)
    _sync(device)
    raise_wall = time.perf_counter() - t0
    raise_iters = inst.last_result.iterations
    used = sc.gto.prop_mass_kg - raised.prop_mass_kg
    d_sma, d_ecc = raised.orbit.sma_km - sc.gto.orbit.sma_km, raised.orbit.ecc - sc.gto.orbit.ecc
    _log(f"  (b) the GTO raise (8x8 f64, Moon and Sun, SRP, eclipse-gated Ruggiero, RK89 at 1e-8, B = 1) over "
         f"{EX03_RAISE_S / 3600.0:g} h of up to 180 days: wall {raise_wall:.3f} s, {raise_iters} iterations, "
         f"{1e3 * raise_wall / raise_iters:.3f} ms an iteration; sma {sc.gto.orbit.sma_km:.3f} -> "
         f"{raised.orbit.sma_km:.6f} km, ecc {sc.gto.orbit.ecc:.6f} -> {raised.orbit.ecc:.9f}, prop used "
         f"{used:.9f} kg, mode {raised.mode}; Pines launches {gp.pines_accel_cuda.launches}")
    if EX03_RAISE_CPU_R_KM is not None and device != "cpu":
        d_r = float(np.linalg.norm(raised.orbit.r_km - np.array(EX03_RAISE_CPU_R_KM)))
        d_v = float(np.linalg.norm(raised.orbit.v_km_s - np.array(EX03_RAISE_CPU_V_KM_S)))
        d_kg = abs(raised.prop_mass_kg - EX03_RAISE_CPU_PROP_KG)
        _log(f"      against the port's CPU run of the arc: {d_r:.3e} km, {d_v:.3e} km/s, {d_kg:.3e} kg")
        if not (d_r < EX03_RAISE_CPU_KM and d_kg < EX03_RAISE_CPU_KG):
            raise RuntimeError(f"ex03 raise: {d_r} km and {d_kg} kg from the CPU run")
    if EX03_RAISE_CPU_R_KM is not None:
        signs = (np.sign(d_sma), np.sign(d_ecc)) == (np.sign(EX03_RAISE_CPU_DSMA_KM), np.sign(EX03_RAISE_CPU_DECC))
        if not (signs and 0.0 < used < 1.0 and np.isfinite(raised.to_vector()).all()):
            raise RuntimeError(f"ex03 raise: sma {d_sma} km, ecc {d_ecc}, prop used {used} kg; the CPU run moved "
                               f"them by {EX03_RAISE_CPU_DSMA_KM} km, {EX03_RAISE_CPU_DECC}, "
                               f"{EX03_RAISE_CPU_USED_KG} kg")
    walls["b"] = time.perf_counter() - t_part

    # (c) the eclipse scan over a two-body day from the raise's end
    t_part = time.perf_counter()
    two_body = Propagator.rk89(SpacecraftDynamics.new(OrbitalDynamics.two_body(sc.gto.frame)), IntegratorOptions())
    _, traj = two_body.with_state(raised, alm, device=device).for_duration_with_traj(86_400.0)
    model = ShadowModel((NAIF.EARTH,), alm)
    _sync(device)
    t0 = time.perf_counter()
    ts, pct = model.percentages(traj, step_s=EX03_ECLIPSE_STEP_S, device=device)
    events = model.find_eclipse_events(traj, step_s=EX03_ECLIPSE_STEP_S, device=device)
    scan_wall = time.perf_counter() - t0
    _, pct_cpu = model.percentages(traj, step_s=EX03_ECLIPSE_STEP_S, device="cpu")
    events_cpu = model.find_eclipse_events(traj, step_s=EX03_ECLIPSE_STEP_S, device="cpu")
    d_pct = float(np.abs(pct - pct_cpu).max())
    d_ev = max([abs((a - b).to_seconds()) for (a, _), (b, _) in zip(events, events_cpu)] or [0.0])
    _log(f"  (c) eclipse scan over a two-body day from (b)'s end ({len(traj)} nodes): {len(ts)} samples every "
         f"{EX03_ECLIPSE_STEP_S:g} s, {100.0 * float(np.mean(pct > 1e-6)):.2f} % in eclipse, {len(events)} "
         f"events ({', '.join(f'{k} at {e}' for e, k in events[:4])}) in {scan_wall:.3f} s; against the CPU: "
         f"percentages {d_pct:.3e}, event epochs {d_ev:.3e} s")
    if not (d_pct < EX03_ECLIPSE_PCT_TOL and d_ev < EX03_ECLIPSE_EVENT_S
            and [k for _, k in events] == [k for _, k in events_cpu]):
        raise RuntimeError(f"ex03 eclipse scan: percentages {d_pct}, events {d_ev} s from the CPU's")
    walls["c"] = time.perf_counter() - t_part

    # (d) raise_optim's first generation
    t_part = time.perf_counter()
    mvn = MvnSpacecraft(sc.gto, [StateDispersion.zero_mean("sma", 0.0)])
    y0 = np.tile(sc.gto.to_vector(), (EX03_OPTIM_P, 1))
    end = sc.epoch + EX03_OPTIM_S
    reset()
    _sync(device)
    t0 = time.perf_counter()
    res = MonteCarlo(mvn, seed=11).run_until_epoch(sc.optim_prop, alm, end, EX03_OPTIM_P, _y0=y0,
                                                   guidance_params=sc.population, device=device)
    _sync(device)
    optim_wall = time.perf_counter() - t0
    prop_used = sc.gto.prop_mass_kg - res.y_final[:, 8]
    penalty = np.zeros(EX03_OPTIM_P)
    for name, idx in (("sma", 0), ("ecc", 1), ("inc", 2)):
        ok_err = np.array([sc.optim_objectives[idx].assess_raw(float(v)) for v in res.final_values_of(name)])
        penalty += np.where(ok_err[:, 0] > 0.5, 0.0, np.abs(ok_err[:, 1]))
    reruns = {}
    for lane in EX03_OPTIM_RERUN_LANES:
        one = MonteCarlo(mvn, seed=11).run_until_epoch(sc.optim_prop, alm, end, 1, _y0=y0[lane:lane + 1],
                                                       guidance_params=sc.population[lane:lane + 1], device=device)
        reruns[lane] = abs(float(sc.gto.prop_mass_kg - one.y_final[0, 8]) - float(prop_used[lane]))
    _log(f"  (d) raise_optim's first generation (4x4 f64, per-lane thresholds) at P = {EX03_OPTIM_P} over "
         f"{EX03_OPTIM_S / 3600.0:g} h of 60 days: wall {optim_wall:.3f} s, {res.iterations} iterations, n_ok "
         f"{res.n_ok}/{res.n_runs}; prop used {prop_used.min():.6f}-{prop_used.max():.6f} kg, penalty x 1000 "
         f"{1000.0 * penalty.min():.3f}-{1000.0 * penalty.max():.3f}; B = 1 reruns of lanes "
         f"{list(reruns)}: prop used within {max(reruns.values()):.3e} kg")
    if res.n_ok != EX03_OPTIM_P or not (np.isfinite(prop_used).all() and (prop_used > 0.0).all()):
        raise RuntimeError(f"ex03 raise_optim: {res.n_ok}/{EX03_OPTIM_P} ok, prop used {prop_used}")
    if not max(reruns.values()) < EX03_OPTIM_RERUN_KG:
        raise RuntimeError(f"ex03 raise_optim: B = 1 reruns differ by {reruns} kg")
    walls["d"] = time.perf_counter() - t_part
    wall_phase = time.perf_counter() - t_phase
    _log("  walls: " + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items()))
    _log(f"ex03 phase: {wall_phase:.1f} s")
    return dict(launches_drift=launches, drift_days_per_min=days_per_min, drift_ms_per_iter=1e3 * wall / iters,
                raised=raised, wall=wall_phase)


def _host_row_kernels(od, scene, sol, head, stations, eom_calls, device):
    """A lower bound on the CUDA kernels of one host-loop row, from two
    cheap profiles (torch.profiler): the arc's first row, at the start
    epoch (its observation, H by `jacfwd` and update, no propagation), and
    one call of the STM EOM at B = 1, times `eom_calls` (the kernel's
    launches a row: one an EOM call). The integrator's own kernels are
    left out."""
    from nyx_tpu_torch.od import TrackingDataArc

    one = TrackingDataArc(head.trackers, head.types, head.epochs_tai_s[:1], head.tracker_idx[:1],
                          head.values[:1])
    start = sol.estimates[0]
    row_k, row_host, row_ops = _kernel_count(lambda: od.process_arc(start, one, stations))
    dyn = od.prop.dynamics
    nominal = start.nominal
    ctx = dyn.build_context(nominal.epoch, 60.0, scene.almanac, device=device)
    eom = dyn.make_eom(True)
    y = torch.as_tensor(np.concatenate([nominal.to_vector(), np.eye(9).ravel()])[None], device=device)
    params = dict(dry_mass_kg=nominal.dry_mass_kg, srp_area_m2=nominal.srp_area_m2,
                  drag_area_m2=nominal.drag_area_m2)
    t = torch.zeros(1, dtype=torch.float64, device=device)
    eom_k, eom_host, eom_ops = _kernel_count(lambda: eom(t, y, ctx, params))
    total = row_k + eom_calls * eom_k
    _log(f"  a row's CUDA kernels (torch.profiler): the first row, at the start epoch, {row_k} (its observation "
         f"and update; {row_ops} top-level aten ops); one STM EOM call at B = 1, {eom_k} ({eom_host} launch "
         f"calls, {eom_ops} top-level aten ops), {eom_calls:.1f} calls a row: ~{total:,.0f} in the update and the "
         f"EOM calls alone, a lower bound (the integrator's own kernels besides)")
    return total


def phase_host_od(gp, tracking, device="cuda"):
    """Phase 6k, the OD host loop on `device` (the card; "cpu" rehearses
    it) on 6i's ex06 scene (`tracking`, phase_tracking_od's return: the
    50x50 split field, the Earth stations with their offset tables, the
    noisy arc and the scan EKF's solution): `ex06_host_od` (the EKF, SNC,
    the 3-sigma gate) over the arc's first EX06_CKF_S, timed, with its
    kernel launches; its accepted and rejected counts and its final
    estimate against the scan EKF's at the same row (EX06_HOST_SCAN_KM)
    and, on the card, against the same loop run on the CPU from the same
    start on the card's rows of the first EX06_HOST_CPU_S
    (EX06_HOST_CPU_KM); its first rows again through the twin (within
    1e-9 km); a lower bound on the CUDA kernels of a row
    (`_host_row_kernels`, on the card); then `smooth` (timed), `nis_test`
    and `postfit_rms`. Returns the summary's numbers."""
    from nyx_tpu_torch.od import MeasurementType

    t_phase = time.perf_counter()
    scene, stations, arc, scan = tracking["scene"], tracking["stations"], tracking["arc"], tracking["sol"]
    head = _head(arc, EX06_CKF_S)
    rows = len(head)
    od = ex06_host_od(scene, device=device)
    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    _sync(device)
    t0 = time.perf_counter()
    sol = od.process_arc(scene.est0, head, stations)
    _sync(device)
    wall = time.perf_counter() - t0
    launches, twin_calls = gp.pines_accel_cuda.launches, gp.pines_accel_torch.cuda_calls
    rate = rows / wall
    final = sol.final_estimate.state().to_vector()
    scan_rej = int(np.sum(np.asarray(scan.rejected)[:rows]))
    d_scan = float(np.linalg.norm(final[:3] - scan.y_est[rows - 1, :3]))
    truth = tracking["traj"].at(sol.final_estimate.epoch).to_vector()
    err_km = float(np.linalg.norm(final[:3] - truth[:3]))
    _log(f"Host OD phase ({_card_line()}), ex06's host loop (EKF, SNC, 3-sigma gate; the 50x50 split field) "
         f"over the arc's first {EX06_CKF_S:g} s: {rows} rows in {wall:.3f} s, {rate:.3f} rows/s; "
         f"{sol.accepted} accepted, {sol.rejected} rejected (the scan EKF: {rows - scan_rej}, {scan_rej}); "
         f"{len(sol)} estimates; Pines launches {launches}, twin primal calls on CUDA {twin_calls}")
    _log(f"  final estimate {d_scan:.3e} km from the scan EKF's at row {rows - 1}, {err_km * 1e3:.3f} m from "
         f"the truth; final position {np.array2string(final[:3], precision=9)} km")
    if (sol.accepted, sol.rejected) != (rows - scan_rej, scan_rej) or not d_scan < EX06_HOST_SCAN_KM:
        raise RuntimeError(f"host OD: {sol.accepted}/{sol.rejected} against the scan EKF's "
                           f"{rows - scan_rej}/{scan_rej}, {d_scan} km apart")
    if launches <= 0 or twin_calls != 0:
        raise RuntimeError(f"host OD did not run through the kernel: {launches} launches, "
                           f"{twin_calls} twin calls on CUDA")
    if torch.device(device).type == "cuda":
        t0 = time.perf_counter()
        cpu_head = _head(head, EX06_HOST_CPU_S)
        cpu = ex06_host_od(scene, device="cpu").process_arc(scene.est0, cpu_head, stations)
        last = cpu.final_estimate.epoch.to_tai_seconds()
        card = sol.at(cpu.final_estimate.epoch)[0].state().to_vector()
        card_rej = sum(r.epoch.to_tai_seconds() <= last + 1e-6 for r in sol.rejected_residuals())
        d_cpu = float(np.linalg.norm(card[:3] - cpu.final_estimate.state().to_vector()[:3]))
        _log(f"  the same loop on the CPU on the card's first {len(cpu_head)} rows "
             f"({time.perf_counter() - t0:.1f} s): {cpu.accepted} accepted, {cpu.rejected} rejected (the "
             f"card: {card_rej} rejected); estimates at the last of them {d_cpu:.3e} km apart")
        if ((cpu.accepted + cpu.rejected, cpu.rejected) != (len(cpu_head), card_rej)
                or not d_cpu < EX06_HOST_CPU_KM):
            raise RuntimeError(f"host OD: {d_cpu} km from the CPU run, counts {cpu.accepted}/{cpu.rejected}")
    # the twin witness: the loop's first rows again through the twin
    twin = ex06_host_od(scene, "torch", device=device).process_arc(scene.est0, _head(head, EX06_HOST_TWIN_S),
                                                                  stations)
    d_twin = float(np.linalg.norm(twin.final_estimate.state().to_vector()[:3]
                                  - sol.at(twin.final_estimate.epoch)[0].state().to_vector()[:3]))
    _log(f"  twin witness over the first {twin.accepted + twin.rejected} rows: estimates {d_twin:.3e} km apart")
    if not d_twin < 1e-9:
        raise RuntimeError(f"host OD: kernel and twin estimates {d_twin} km apart")
    kernels = None
    if torch.device(device).type == "cuda":
        kernels = _host_row_kernels(od, scene, sol, head, stations, launches / rows, device)
    _sync(device)
    t0 = time.perf_counter()
    smoothed = sol.smooth(devices=stations, device=device)
    smooth_wall = time.perf_counter() - t0
    nis = sol.nis_test()
    rms_m = 1e3 * sol.postfit_rms(MeasurementType.RANGE_KM)
    _log(f"  smooth: {smooth_wall:.3f} s ({len(smoothed)} estimates); NIS {nis['verdict']} (mean "
         f"{nis['mean_nis']:.3f}); range postfit RMS {rms_m:.3f} m")
    if len(smoothed) != len(sol) or not np.isfinite(rms_m):
        raise RuntimeError("host OD: the smoother or the statistics failed")
    _log(f"Host OD phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, rows_per_s=rate, kernels_per_row=kernels, smooth_s=smooth_wall,
                final=final)


DHALL_OD_PROPAGATOR = """
-- the OD leg's propagator: 21x21 JGM3 about the Earth (split precision is
-- not a Dhall field), RK89 at the default options
{ accel_models =
    { gravity_field = Some
        { _1 = { filepath = "%s", degree = 21, order = 21, gunzipped = True }
        , _2 = { ephemeris_id = +399, orientation_id = +399 }
        }
    , point_masses = None { celestial_objects : List Integer }
    }
, force_models = { solar_pressure = None { phi : Optional Double }, drag = None { density : Text } }
, method = "RungeKutta89"
, options =
    { init_step = "60 s", min_step = "0.001 s", max_step = "2700 s", tolerance = 1.0e-12
    , attempts = 50, fixed_step = False, error_ctrl = "RSSCartesianStep"
    }
}
"""


def phase_scan_modes(gp, stor21, od, device="cuda"):
    """Phase 6l, the scan filter's modes on 6b's scene (`od`, phase_od's
    return: the one-day truth, its arc, the estimate and 6b's timed f32
    solution) on `device` (the card; "cpu" rehearses it), printed as "Scan
    modes phase": (a) `filter_mode="parallel"` against the sequential scan,
    both f64 with the 4-sigma gate, on the arc's first SCAN_GATE_S with ~3 %
    of the range rows moved by +5 km: the same rejections, every moved row
    among them, final estimates within SCAN_PARALLEL_KM of each other, both
    within 100 m of the truth; (a') the parallel filter over the whole clean
    day, timed, its s4 beside 6b's, within 100 m of the truth and within
    `_f32_vs_f64`'s bounds of 6b's f32 solution; (b) `process_arc_batch`
    over SCAN_ENSEMBLE_B estimates at 6b's settings (CKF, stm_jvp_degree 8,
    f32) on the whole day, timed, member 0 (6b's estimate) within
    SCAN_MEMBER_KM of 6b's solution, every member within 100 m of the
    truth; (c) DSS-65 and DSS-34 with a Gauss-Markov range bias (tau 30
    days, process noise 0.02 km; tests/test_od.py:535-547) every
    SCAN_BIAS_CADENCE_S over SCAN_BIAS_S, the CKF with and without
    `estimate_biases`: each station's injected bias within 3 sigma + 1 m,
    the final error with the lanes below the error without; (d)
    `prop_mode` "fixed" and "adaptive" over the arc's first SCAN_ROWS rows
    against the batch CKF on the same rows (SCAN_ROW_KM), timed; (e) the spacecraft and integrator options
    through TOML, the propagator's Dhall document (held field by field to
    the propagator built in code), and the final estimate's spacecraft
    through DER. Every filter that propagates runs the Pines kernel (> 0
    launches, no twin primal call on CUDA). Returns the summary's numbers."""
    from nyx_tpu_torch import Epoch, Frames
    from nyx_tpu_torch.dynamics import sequence
    from nyx_tpu_torch.io import config, der
    from nyx_tpu_torch.od import (
        GaussMarkov, KfEstimate, MeasurementType, ScanKalmanOD, Scheduler, StochasticNoise,
        TrackingArcSim, TrkConfig, WhiteNoise,
    )
    from nyx_tpu_torch.propagators import IntegratorOptions

    t_phase = time.perf_counter()
    types = (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S)
    truth, traj, arc, est0, sol_b = od["truth"], od["traj"], od["arc"], od["est0"], od["sol"]
    walls = {}

    def make(stations=None, **kw):
        return ScanKalmanOD(_od_propagator(stor21, "auto"), stations or od["stations"], types=types,
                            variant="ckf", stm_jvp_degree=8, device=device, **kw)

    def err_km(sol):
        fin = traj.at(Epoch.from_tai_seconds_j2000(float(sol.epochs_tai_s[-1]))).to_vector()
        return float(np.linalg.norm(sol.final_state()[:3] - fin[:3]))

    def counted(label, fn):
        """fn() with the kernel's counters reset before it, timed; raises
        unless it launched the kernel and never the twin's primal on CUDA."""
        gp.pines_accel_cuda.launches = 0
        gp.pines_accel_torch.cuda_calls = 0
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        wall, launches = time.perf_counter() - t0, gp.pines_accel_cuda.launches
        if launches <= 0 or gp.pines_accel_torch.cuda_calls != 0:
            raise RuntimeError(f"scan modes {label} did not run through the kernel: {launches} launches, "
                               f"{gp.pines_accel_torch.cuda_calls} twin primal calls on CUDA")
        return out, wall, launches

    _log(f"Scan modes phase ({_card_line()}), on 6b's scene ({len(arc)} rows over a day):")
    # (a) the parallel filter's gate against the sequential scan's
    t_part = time.perf_counter()
    head = _head(arc, SCAN_GATE_S)
    rng = np.random.default_rng(42)
    vals = np.array(head.values)
    bad = rng.choice(len(head), size=len(head) // 33, replace=False)
    vals[bad, head.types.index(MeasurementType.RANGE_KM)] += 5.0
    bad_arc = dataclasses.replace(head, values=vals)
    gated = {}
    for mode in ("scan", "parallel"):
        gated[mode], wall, launches = counted(
            f"(a) {mode}", lambda m=mode: make(filter_mode=m, resid_rejection_sigmas=4.0).process_arc(
                est0, bad_arc))
        _log(f"  (a) {mode}, f64, 4-sigma gate, first {SCAN_GATE_S / 3600.0:g} h ({len(head)} rows, "
             f"{len(bad)} range rows moved by +5 km): {wall:.3f} s, {launches} launches; rejected "
             f"{int(gated[mode].rejected.sum())}, {err_km(gated[mode]) * 1e3:.3f} m from the truth")
    seq, par = gated["scan"], gated["parallel"]
    d_par = float(np.linalg.norm(seq.final_state()[:3] - par.final_state()[:3]))
    d_rows = float(np.linalg.norm(seq.y_est[:, :3] - par.y_est[:, :3], axis=1).max())
    same = bool(np.array_equal(seq.rejected, par.rejected))
    _log(f"  (a) rejections identical: {same}; every moved row rejected: scan "
         f"{bool(seq.rejected[bad].all())}, parallel {bool(par.rejected[bad].all())}; final estimates "
         f"{d_par:.3e} km apart (rows at most {d_rows:.3e} km)")
    if not (same and seq.rejected[bad].all() and par.rejected[bad].all() and d_par < SCAN_PARALLEL_KM):
        raise RuntimeError(f"scan modes (a): the parallel gate parts from the scan's ({d_par} km)")
    if not max(err_km(seq), err_km(par)) < OD_GUARD_KM:
        raise RuntimeError("scan modes (a): a gated filter diverged")
    walls["a"] = time.perf_counter() - t_part

    # (a') the parallel filter over the whole clean day, timed
    t_part = time.perf_counter()
    par_od = make(filter_mode="parallel")
    par_day, par_wall, par_launches = counted("(a')", lambda: par_od.process_arc(est0, arc))
    par_s4 = par_od.stage_walls_s["s4"]
    _log(f"  (a') parallel, f64, the whole day: {par_wall:.3f} s, {len(arc) / par_wall:.2f} rows/s, "
         f"{par_launches} launches; stages "
         + ", ".join(f"{k} {par_od.stage_walls_s[k]:.3f} s" for k in ("s1", "s2", "s3", "s4"))
         + f" (6b's s4, the f32 scan: {od['s4']:.3f} s); {err_km(par_day) * 1e3:.3f} m from the truth")
    if not err_km(par_day) < OD_GUARD_KM:
        raise RuntimeError("scan modes (a'): the parallel filter diverged")
    _f32_vs_f64("  (a') 6b's f32 scan against the parallel filter,", sol_b, par_day)
    walls["a'"] = time.perf_counter() - t_part

    # (b) the ensemble of filters at 6b's settings, timed
    t_part = time.perf_counter()
    draws = np.random.default_rng(SCAN_ENSEMBLE_SEED).multivariate_normal(
        np.zeros(9), est0.covar, size=SCAN_ENSEMBLE_B - 1)
    ests = [est0] + [KfEstimate.from_covar(truth.set_vector(truth.epoch, truth.to_vector() + d),
                                           est0.covar) for d in draws]
    ens_od = make(filter_algebra="f32")
    ens, ens_wall, ens_launches = counted("(b)", lambda: ens_od.process_arc_batch(ests, arc))
    d_member = float(np.linalg.norm(ens[0].final_state()[:3] - sol_b.final_state()[:3]))
    errs = np.array([err_km(s) for s in ens])
    w = ens_od.stage_walls_s
    _log(f"  (b) process_arc_batch, B = {len(ests)}, CKF f32, the whole day: {ens_wall:.3f} s "
         f"({ens_wall / od['wall']:.2f}x 6b's single filter, {od['wall']:.3f} s), "
         f"{len(ests) / ens_wall:.2f} filters/s, {len(ests) * len(arc) / ens_wall:.1f} filter-rows/s, "
         f"{ens_launches} launches; stages "
         + ", ".join(f"{k} {w[k]:.3f} s" for k in ("s1", "s2", "s3", "s4"))
         + f", s1 iterations {w['s1_iterations']}; member 0 {d_member:.3e} km from 6b's solution; "
         f"members {1e3 * errs.min():.3f}-{1e3 * errs.max():.3f} m from the truth")
    if not (d_member < SCAN_MEMBER_KM and errs.max() < OD_GUARD_KM and np.isfinite(errs).all()):
        raise RuntimeError(f"scan modes (b): member 0 {d_member} km from 6b, worst member {errs.max()} km")
    walls["b"] = time.perf_counter() - t_part

    # (c) Gauss-Markov range biases estimated as state lanes
    t_part = time.perf_counter()
    biased = _dsn_stations()[:2]
    for gs in biased:
        gs.stochastic_noises[types[0]] = StochasticNoise(
            WhiteNoise(2.0e-3), GaussMarkov(tau_s=30 * 86400.0, process_noise=0.02))
    cfg = TrkConfig(sampling_s=SCAN_BIAS_CADENCE_S, scheduler=Scheduler(min_samples=5))
    bias_arc = _head(TrackingArcSim.with_seed(biased, traj, {g.name: cfg for g in biased}, seed=5,
                                              device=device).generate_measurements(), SCAN_BIAS_S)
    col = bias_arc.types.index(types[0])
    true_bias = {}
    for gs in biased:
        rows = [i for i in range(len(bias_arc)) if bias_arc.trackers[bias_arc.tracker_idx[i]] == gs.name]
        eps = [Epoch.from_tai_seconds_j2000(float(bias_arc.epochs_tai_s[i])) for i in rows]
        rv = torch.tensor(np.stack([traj.at(e).to_vector()[:6] for e in eps]), device=device)
        t_tdb = torch.tensor([e.to_tdb_seconds() for e in eps], dtype=torch.float64, device=device)
        noiseless = gs.measurement_fn(types[:1])(t_tdb, rv)[:, 0].cpu().numpy()
        true_bias[gs.name] = float(np.mean(bias_arc.values[rows, col] - noiseless))
    (with_b, without_b), wall, launches = counted("(c)", lambda: (
        make(biased, estimate_biases=True).process_arc(est0, bias_arc),
        make(biased).process_arc(est0, bias_arc)))
    err_b, err_nb = err_km(with_b), err_km(without_b)
    _log(f"  (c) bias lanes {with_b.bias_lanes}, {len(bias_arc)} rows every {SCAN_BIAS_CADENCE_S:g} s over "
         f"{SCAN_BIAS_S / 3600.0:g} h, CKF f64 with and without them: {wall:.3f} s, {launches} launches")
    ok = with_b.bias_lanes == tuple((g.name, types[0]) for g in biased)
    for k, (name, _) in enumerate(with_b.bias_lanes):
        est_k, sig_k = float(with_b.bias_est[-1, k]), float(np.sqrt(with_b.bias_var[-1, k]))
        _log(f"      {name}: estimated {est_k * 1e3:.3f} m, injected {true_bias[name] * 1e3:.3f} m, "
             f"3 sigma {3e3 * sig_k:.3f} m")
        ok = ok and abs(est_k - true_bias[name]) < 3.0 * sig_k + 1e-3
    _log(f"      final error with the lanes {err_b * 1e3:.3f} m, without {err_nb * 1e3:.3f} m")
    if not (ok and err_b < err_nb):
        raise RuntimeError("scan modes (c): the bias lanes did not recover the injected biases")
    walls["c"] = time.perf_counter() - t_part

    # (d) the per-row modes against the batch CKF on the same rows
    t_part = time.perf_counter()
    rows_arc = dataclasses.replace(arc, epochs_tai_s=arc.epochs_tai_s[:SCAN_ROWS],
                                   tracker_idx=arc.tracker_idx[:SCAN_ROWS], values=arc.values[:SCAN_ROWS])
    batch = make().process_arc(est0, rows_arc)
    row_rates = {}
    for mode in ("fixed", "adaptive"):
        sol, wall, launches = counted(f"(d) {mode}", lambda m=mode: make(prop_mode=m).process_arc(est0, rows_arc))
        gap = float(np.linalg.norm(sol.y_est[:, :3] - batch.y_est[:, :3], axis=1).max())
        row_rates[mode] = SCAN_ROWS / wall
        _log(f"  (d) prop_mode {mode!r}, the first {SCAN_ROWS} rows: {wall:.3f} s, {row_rates[mode]:.3f} "
             f"rows/s, {launches} launches; largest row gap to the batch CKF {gap:.3e} km (bound "
             f"{SCAN_ROW_KM:.3e})")
        if not gap < SCAN_ROW_KM:
            raise RuntimeError(f"scan modes (d): {mode} {gap} km from the batch CKF")
    walls["d"] = time.perf_counter() - t_part

    # (e) the documents
    t_part = time.perf_counter()
    prop = _od_propagator(stor21, "auto")
    final_sc = truth.set_vector(Epoch.from_tai_seconds_j2000(float(sol_b.epochs_tai_s[-1])),
                                sol_b.final_state())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        config.save_spacecraft(final_sc, tmp / "sc.toml")
        sc_back = config.load_spacecraft(tmp / "sc.toml")
        config.save_integrator_options(prop.opts, tmp / "opts.toml")
        opts_back = config.load_integrator_options(tmp / "opts.toml")
        (tmp / "prop.dhall").write_text(DHALL_OD_PROPAGATOR % (HERE / "data" / "JGM3.cof.gz"))
        cfg = sequence.load_dhall_propagator(tmp / "prop.dhall")
    g = cfg.dynamics.gravity_field
    dhall_ok = (g["degree"], g["order"], g["gunzipped"], g["frame"], cfg.method, cfg.options) == (
        stor21.max_degree, stor21.max_order, True, Frames.IAU_EARTH, "rk89", prop.opts) and \
        cfg.options == IntegratorOptions() and Path(g["path"]).name == "JGM3.cof.gz"
    data = der.spacecraft_to_der(final_sc)
    sc_der = der.spacecraft_from_der(data)
    der_ok = (np.array_equal(sc_der.orbit.r_km, final_sc.orbit.r_km)
              and np.array_equal(sc_der.orbit.v_km_s, final_sc.orbit.v_km_s)
              and sc_der.orbit.epoch.to_tai_seconds() == final_sc.orbit.epoch.to_tai_seconds()
              and all(getattr(sc_der, f) == getattr(final_sc, f) for f in (
                  "dry_mass_kg", "prop_mass_kg", "srp_area_m2", "cr", "drag_area_m2", "cd", "thruster")))
    toml_ok = (config.spacecraft_to_dict(sc_back) == config.spacecraft_to_dict(final_sc)
               and opts_back == prop.opts)
    walls["e"] = time.perf_counter() - t_part
    _log(f"  (e) documents: the final estimate's spacecraft and the integrator options through TOML, read "
         f"back equal: {toml_ok}; the propagator's Dhall document (21x21 JGM3, RK89, default options; "
         f"split precision is not a Dhall field) equal to the propagator built in code field by field: "
         f"{dhall_ok}; the spacecraft through DER ({len(data)} bytes) equal to the bit: {der_ok}; "
         f"{walls['e']:.3f} s")
    if not (toml_ok and dhall_ok and der_ok):
        raise RuntimeError("scan modes (e): a document did not read back equal")
    wall_phase = time.perf_counter() - t_phase
    _log("  walls: " + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items()))
    _log(f"Scan modes phase: {wall_phase:.1f} s")
    return dict(parallel_rows_per_s=len(arc) / par_wall, parallel_s4=par_s4, ensemble_filters=len(ests),
                ensemble_wall=ens_wall, launches_ensemble=ens_launches, fixed_rows_per_s=row_rates["fixed"],
                wall=wall_phase)


def hifi_files(out_dir: Path, stor21, epoch, seconds: float = HIFI_SECONDS):
    """Phase 6m's files, written by the port into `out_dir`: an EGM2008-format
    text file of `stor21`'s coefficients (17 significant digits, D
    exponents, so they read back to the bit), and the Moon's and the Sun's
    SPK type-3 segments about the Earth from the port's analytic almanac,
    covering [epoch, epoch + seconds] with HIFI_SPK_MARGIN_DAYS on each
    side. Returns (egm_path, [moon_path, sun_path])."""
    from nyx_tpu_torch.constants import NAIF
    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.io.spk import write_spk_type3

    egm = out_dir / "egm2008_jgm3_21x21.txt"
    with open(egm, "w") as f:
        for n in range(2, stor21.max_degree + 1):
            for m in range(min(n, stor21.max_order) + 1):
                c, s = (f"{x:.16E}".replace("E", "D") for x in (stor21.c_nm[n, m], stor21.s_nm[n, m]))
                f.write(f"{n:5d} {m:5d} {c} {s} 0.0D+00 0.0D+00\n")
    analytic = Almanac()
    pad = HIFI_SPK_MARGIN_DAYS * 86_400.0
    t0, t1 = epoch.to_tdb_seconds() - pad, epoch.to_tdb_seconds() + seconds + pad

    def states(body):
        def sample(ts):
            h = 2.0
            r = analytic.position(body, NAIF.EARTH, ts)
            v = (analytic.position(body, NAIF.EARTH, ts + h) - analytic.position(body, NAIF.EARTH, ts - h)) / (2 * h)
            return np.concatenate([r, v], axis=1)
        return sample

    spks = [write_spk_type3(out_dir / name, body, NAIF.EARTH, 1, t0, t1, states(body), intlen, 11)
            for name, body, intlen in (("moon_hifi.bsp", NAIF.MOON, 86_400.0),
                                       ("sun_hifi.bsp", NAIF.SUN, 4 * 86_400.0))]
    return egm, spks


def hifi_propagator(field, pert_precision: str = "f32", backend: str = "auto"):
    """Phase 6m's propagator: `field` (a GravityFieldData) at f64 precision,
    Moon and Sun point masses, solid tides, SRP and the 1976 atmosphere, with
    the perturbations at `pert_precision`; RK89 at Config 2's tolerances."""
    from nyx_tpu_torch import Frames
    from nyx_tpu_torch.constants import NAIF
    from nyx_tpu_torch.dynamics import (
        Drag, Harmonics, OrbitalDynamics, PointMasses, SolarPressure, SolidTides, SpacecraftDynamics,
    )
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    orbital = OrbitalDynamics.from_models(
        (Harmonics.from_stor(field, "f64", backend), PointMasses((NAIF.MOON, NAIF.SUN)),
         SolidTides.earth_moon_system()), Frames.EME2000)
    dyn = SpacecraftDynamics(orbital, (SolarPressure.default(), Drag.std_atm1976()),
                             pert_precision=pert_precision)
    return Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9))


def phase_hifi(gp, stor21, mvn, device="cuda"):
    """Phase 6m, the file-driven high-fidelity Earth dynamics on Config 2's
    scene: the field read back from an EGM2008 file, the Moon and the Sun
    from SPK files, solid tides, SRP and the 1976 atmosphere, the
    perturbations at f32 (the Pines kernel over the whole f64-precision
    field at q_lo 0 in every stage). (a) B_MAIN lanes over HIFI_SECONDS
    through the kernel, timed, launches counted; (b) lanes 0-63 through the
    twin; (c) the same lanes with f64 perturbations; (d) HIFI_B_CPU lanes of
    (b) on the CPU; (b)-(d) over the first HIFI_RERUN_S, against a kernel
    run of the same lanes over it. Returns the summary's numbers."""
    from nyx_tpu_torch import Frames
    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.io.gravity import GravityFieldData
    from nyx_tpu_torch.mc import MonteCarlo

    t_phase = time.perf_counter()
    epoch = mvn.template.epoch
    end = epoch + HIFI_SECONDS
    with tempfile.TemporaryDirectory() as tmp:
        egm, spks = hifi_files(Path(tmp), stor21, epoch)
        field = GravityFieldData.from_egm2008(egm, 21, 21, frame=Frames.IAU_EARTH)
        if not (np.array_equal(field.c_nm, stor21.c_nm) and np.array_equal(field.s_nm, stor21.s_nm)):
            raise RuntimeError("hifi: the EGM2008 file did not read back the 21x21 coefficients")
        alm = Almanac(spks)
    t_files = time.perf_counter() - t_phase

    def run(n, pert_precision, backend, dev, y0=None, until=end):
        _sync(dev)
        t0 = time.perf_counter()
        res = MonteCarlo(mvn, seed=42).run_until_epoch(
            hifi_propagator(field, pert_precision, backend), alm, until, n, device=dev, _y0=y0)
        _sync(dev)
        return res, time.perf_counter() - t0

    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    res, wall = run(B_MAIN, "f32", "auto", device)
    launches, twin_calls = gp.pines_accel_cuda.launches, gp.pines_accel_torch.cuda_calls
    _log(f"hifi ({_card_line()}), B={B_MAIN}, {HIFI_SECONDS:g} s (files {t_files:.2f} s): wall "
         f"{wall:.3f} s, {res.n_ok / wall:.2f} traj/s, iterations {res.iterations}, mean accepted "
         f"{float(np.mean(res.n_accepted)):.2f}, mean rejected {float(np.mean(res.n_rejected)):.2f}, "
         f"n_ok/n_runs {res.n_ok}/{res.n_runs}, kernel launches {launches}, twin CUDA calls {twin_calls}")
    if res.n_ok != B_MAIN or not np.isfinite(res.y_final).all():
        raise RuntimeError(f"hifi: {res.n_ok}/{B_MAIN} lanes ok")
    if device == "cuda" and (launches <= 0 or twin_calls != 0):
        raise RuntimeError(f"hifi did not run through the kernel: {launches} launches, "
                           f"{twin_calls} twin calls on CUDA")

    y0, until = res.y_initial[:HIFI_B_TWIN], epoch + HIFI_RERUN_S
    kernel, wall_kernel = run(HIFI_B_TWIN, "f32", "auto", device, y0, until)
    twin, wall_twin = run(HIFI_B_TWIN, "f32", "torch", device, y0, until)
    f64, wall_f64 = run(HIFI_B_TWIN, "f64", "auto", device, y0, until)
    cpu, wall_cpu = run(HIFI_B_CPU, "f32", "torch", "cpu", y0[:HIFI_B_CPU], until)
    if min(kernel.n_ok, twin.n_ok, f64.n_ok) < HIFI_B_TWIN or cpu.n_ok != HIFI_B_CPU:
        raise RuntimeError(f"hifi reruns: {kernel.n_ok}, {twin.n_ok}, {f64.n_ok} of {HIFI_B_TWIN} and "
                           f"{cpu.n_ok} of {HIFI_B_CPU} ok")

    def gap(a, b):
        return float(np.linalg.norm(a.y_final[:, :3] - b.y_final[: len(a.y_final), :3], axis=1).max())

    d_twin, d_f64, d_cpu = gap(twin, kernel), gap(f64, twin), gap(cpu, twin)
    _log(f"hifi reruns over {HIFI_RERUN_S:g} s (the kernel's {HIFI_B_TWIN} lanes {wall_kernel:.2f} s): (b) the "
         f"twin {wall_twin:.2f} s, {twin.iterations} iterations, {d_twin:.3e} km from the kernel's; (c) f64 "
         f"perturbations {wall_f64:.2f} s, {f64.iterations} iterations, {d_f64:.3e} km from (b); (d) the CPU's "
         f"{HIFI_B_CPU} lanes {wall_cpu:.2f} s, {cpu.iterations} iterations, {d_cpu:.3e} km from (b)")
    for label, d, tol in (("twin", d_twin, TWIN_FINAL_TOL_KM), ("f64 perturbations", d_f64, HIFI_F64_TOL_KM),
                          ("CPU", d_cpu, TWIN_FINAL_TOL_KM)):
        if not d < tol:
            raise RuntimeError(f"hifi: the {label} run is {d} km from its reference run (bound {tol})")
    _log(f"hifi phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, traj_per_s=res.n_ok / wall, wall=wall, iterations=res.iterations,
                gaps_km=(d_twin, d_f64, d_cpu))


def phase_mesh(gp, leo, od, stor21, device="cuda"):
    """Phase 6n, ensembles sharded over a mesh of devices (parallel/mesh.py),
    printed as "Mesh phase": the mesh of every card present
    (`ensemble_mesh()`) and a mesh of MESH_SHARDS shards of one card, where
    each shard runs in a host thread of its own under a CUDA stream of its
    own, the shards of one card in turn. (a) Config 2 at B_MAIN over MESH_SECONDS (`leo`: main()'s
    propagator factory, draws and almanac) unsharded, on the mesh of every
    card and on the shards (B_MAIN is no multiple of MESH_SHARDS, so the
    padding runs), timed, launches counted by shard and summed, every lane
    ok, every final within MESH_TOL_KM of the unsharded run's; (b) Config
    2's Encke mode (ABM) at MESH_ENCKE_B over MESH_ENCKE_SECONDS on the
    shards against one device, inside `tracing.profile_trace` over the
    card's activity only (each shard a named region), the trace's Pines
    kernels as many as the launch counter moved; (c) `process_arc_batch`
    over MESH_OD_FILTERS estimates (6b's and draws from its covariance) on
    6b's arc's first MESH_OD_SECONDS (`od`, phase_od's return), CKF at f64
    algebra (at f32 the batch width moves
    the estimates by ~1e-5 km: cuBLAS and cuSOLVER pick their algorithm
    by batch size), on the shards against the unsharded batch: finals
    within MESH_TOL_KM, the same rejections. Every run through the kernel,
    no twin primal call on CUDA. With one card present, multi-card scaling
    is not measured. Returns the summary's numbers."""
    from nyx_tpu_torch import tracing
    from nyx_tpu_torch.mc import MonteCarlo
    from nyx_tpu_torch.od import KfEstimate, MeasurementType, ScanKalmanOD
    from nyx_tpu_torch.parallel import Mesh, ensemble_mesh

    t_phase = time.perf_counter()
    card = torch.device(device) if device == "cpu" else torch.device("cuda", 0)
    shards = Mesh((card,) * MESH_SHARDS)
    cards = ensemble_mesh() if device == "cuda" else Mesh((card,))
    epoch = leo.mvn.template.epoch

    def counted(label, fn):
        """fn() timed with the kernel's counters reset before it: (its
        value, wall, launches, launches by host thread); raises unless it
        ran the kernel, never the twin's primal on CUDA, and the threads'
        launches sum to the counter's."""
        gp.pines_accel_cuda.launches = 0
        gp.pines_accel_torch.cuda_calls = 0
        _sync(device)
        t0 = time.perf_counter()
        with _launches_by_thread(gp) as tally:
            out = fn()
            _sync(device)
        wall, launches = time.perf_counter() - t0, gp.pines_accel_cuda.launches
        by_thread = dict(sorted(tally.items()))
        if launches <= 0 or gp.pines_accel_torch.cuda_calls != 0:
            raise RuntimeError(f"mesh {label} did not run through the kernel: {launches} launches, "
                               f"{gp.pines_accel_torch.cuda_calls} twin primal calls on CUDA")
        if sum(by_thread.values()) != launches:
            raise RuntimeError(f"mesh {label}: the threads' launches {by_thread} do not sum to {launches}")
        return out, wall, launches, by_thread

    def gap_km(a, b):
        return float(np.linalg.norm(np.asarray(a)[:, :3] - np.asarray(b)[:, :3], axis=1).max())

    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    _log(f"Mesh phase ({_card_line()}; {n_cards} card(s)"
         f"{'' if n_cards > 1 else ': multi-card scaling is not measured with one card'}):")
    # (a) Config 2 at full width: unsharded, every card, MESH_SHARDS shards of one card
    t_part = time.perf_counter()
    prop = leo.propagator("auto")
    runs = {}
    for label, mesh in (("unsharded", None), (f"ensemble_mesh() of {cards.size} card(s)", cards),
                        (f"{MESH_SHARDS} shards of {card}", shards)):
        res, wall, launches, by_thread = counted(f"(a) {label}", lambda m=mesh: MonteCarlo(
            leo.mvn, seed=42).run_until_epoch(prop, leo.almanac, epoch + MESH_SECONDS, B_MAIN,
                                              mesh=m, device=device))
        if res.n_ok != B_MAIN or res.n_runs != B_MAIN or not np.isfinite(res.y_final).all():
            raise RuntimeError(f"mesh (a) {label}: {res.n_ok}/{res.n_runs} lanes ok")
        if mesh is not None and len(by_thread) != mesh.size:
            raise RuntimeError(f"mesh (a) {label}: launches from {sorted(by_thread)}, not {mesh.size} shards")
        d = 0.0 if mesh is None else gap_km(res.y_final, runs["unsharded"][0].y_final)
        runs[label] = (res, wall, launches, by_thread, d)
        _log(f"  (a) Config 2, B={B_MAIN}, {MESH_SECONDS:g} s, {label}: wall {wall:.3f} s, "
             f"{B_MAIN / wall:.2f} traj/s, iterations {res.iterations}, n_ok {res.n_ok}/{res.n_runs}, "
             f"kernel launches {launches} ({', '.join(f'{k} {v}' for k, v in by_thread.items())}), "
             f"finals {d:.3e} km from the unsharded run's")
        if not d <= MESH_TOL_KM:
            raise RuntimeError(f"mesh (a) {label}: finals {d} km from the unsharded run (bound {MESH_TOL_KM})")
    wall_a = time.perf_counter() - t_part

    # (b) Config 2's Encke mode on the shards, profiled
    t_part = time.perf_counter()
    mc = MonteCarlo(leo.mvn, seed=42)
    end_e = epoch + MESH_ENCKE_SECONDS
    (plain_e, wall_pe, launches_pe, _) = counted("(b) unsharded", lambda: mc.run_until_epoch_encke(
        prop, leo.almanac, end_e, MESH_ENCKE_B, integ="abm", device=card))
    with tempfile.TemporaryDirectory() as tmp:
        # the card's activity only (host_tracer_level 0): the guard reads
        # only the kernels
        with tracing.profile_trace(tmp, 0 if device == "cuda" else 1,
                                   cuda=device == "cuda") as session:
            (enc, wall_e, launches_e, by_thread_e) = counted("(b) sharded", lambda: mc.run_until_epoch_encke(
                prop, leo.almanac, end_e, MESH_ENCKE_B, integ="abm", mesh=shards))
            t_stop = time.perf_counter()
        t_read = time.perf_counter()
        data = session.trace_path.read_bytes()
        trace_mb = len(data) / 1e6
        traced = len(re.findall(rb'"cat":\s*"kernel",\s*"name":\s*"[^"]*pines_kernel', data))
        regions = sorted({m.decode() for m in re.findall(rb'"name":\s*"(mc encke shard \d+ on [^"]+)"', data)})
        del data
    t_trace, t_read = t_read - t_stop, time.perf_counter() - t_read
    d_e = gap_km(enc.y_final, plain_e.y_final)
    _log(f"  (b) Config 2's Encke (ABM), B={MESH_ENCKE_B}, {MESH_ENCKE_SECONDS:g} s: unsharded {wall_pe:.3f} s "
         f"(the reference's nominal built in it), {launches_pe} launches; {MESH_SHARDS} shards {wall_e:.3f} s "
         f"under the profiler, {launches_e} launches ({', '.join(f'{k} {v}' for k, v in by_thread_e.items())}); "
         f"the trace ({trace_mb:.1f} MB; the profiler's stop and export {t_trace:.1f} s, its read {t_read:.1f} s) "
         f"lists {traced} Pines kernels and the shard regions {regions or 'none (not attributed)'}; "
         f"finals {d_e:.3e} km from the unsharded run's")
    if enc.n_ok != MESH_ENCKE_B or plain_e.n_ok != MESH_ENCKE_B or not d_e <= MESH_TOL_KM:
        raise RuntimeError(f"mesh (b): {enc.n_ok}/{MESH_ENCKE_B} ok, finals {d_e} km apart")
    if device == "cuda" and traced != launches_e:
        raise RuntimeError(f"mesh (b): the trace lists {traced} Pines kernels, the counter {launches_e}")
    wall_b = time.perf_counter() - t_part

    # (c) an ensemble of filters on the shards
    t_part = time.perf_counter()
    types = (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S)
    head = _head(od["arc"], MESH_OD_SECONDS)
    truth, est0 = od["truth"], od["est0"]
    draws = np.random.default_rng(SCAN_ENSEMBLE_SEED).multivariate_normal(
        np.zeros(9), est0.covar, size=MESH_OD_FILTERS - 1)
    ests = [est0] + [KfEstimate.from_covar(truth.set_vector(truth.epoch, truth.to_vector() + d),
                                           est0.covar) for d in draws]
    filt = ScanKalmanOD(_od_propagator(stor21, "auto"), od["stations"], types=types, variant="ckf",
                        stm_jvp_degree=8, filter_algebra="f64", device=device)
    plain_f, wall_pf, launches_pf, _ = counted("(c) unsharded", lambda: filt.process_arc_batch(ests, head))
    sharded_f, wall_f, launches_f, by_thread_f = counted(
        "(c) sharded", lambda: filt.process_arc_batch(ests, head, mesh=shards))
    d_f = max(gap_km(a.y_est, b.y_est) for a, b in zip(sharded_f, plain_f))
    same = all(np.array_equal(a.rejected, b.rejected) for a, b in zip(sharded_f, plain_f))
    _log(f"  (c) process_arc_batch, {len(ests)} filters (CKF f64), {len(head)} rows over "
         f"{MESH_OD_SECONDS / 3600.0:g} h: unsharded {wall_pf:.3f} s, {len(ests) / wall_pf:.2f} filters/s, "
         f"{launches_pf} launches; {MESH_SHARDS} shards {wall_f:.3f} s, {len(ests) / wall_f:.2f} filters/s, "
         f"{launches_f} launches ({', '.join(f'{k} {v}' for k, v in by_thread_f.items())}); estimates "
         f"{d_f:.3e} km apart at most, rejections identical: {same}")
    if len(sharded_f) != len(ests) or not (same and d_f <= MESH_TOL_KM):
        raise RuntimeError(f"mesh (c): {len(sharded_f)} results, estimates {d_f} km apart, same rejections {same}")
    wall_c = time.perf_counter() - t_part
    _log(f"  walls: (a) {wall_a:.1f} s, (b) {wall_b:.1f} s, (c) {wall_c:.1f} s")
    _log(f"Mesh phase: {time.perf_counter() - t_phase:.1f} s")
    sharded = runs[f"{MESH_SHARDS} shards of {card}"]
    return dict(launches=sharded[2], traj_per_s=B_MAIN / sharded[1], shards=len(sharded[3]),
                max_gap_km=max(max(r[4] for r in runs.values()), d_e, d_f),
                walls={k: r[1] for k, r in runs.items()}, filters_per_s=len(ests) / wall_f)


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
        "moon50x50": Harmonics.from_stor(ex06_moon_field(EX06_DEGREE), "split"),
    }
    k3 = phase_kernel_vs_twin(gp, fields, parent)

    # phase 3b: the fused EOM against the composed one at Config 2's composition
    epoch = Epoch.from_gregorian_utc(2021, 3, 4)
    orbit = Orbit.keplerian(7136.6, 2e-4, 51.6, 30.0, 65.0, 80.0, epoch, Frames.EME2000)
    sc = Spacecraft.new(orbit, 100.0, 0.0, 2.0, 2.0, 1.8, 2.2)
    built = _cuda.load("eom")
    _log(f"built eom: {built.path} in {built.seconds:.2f} s")
    k3b = phase_fused_eom(gp, fields, epoch, dict(dry_mass_kg=sc.dry_mass_kg, srp_area_m2=sc.srp_area_m2,
                                                  drag_area_m2=sc.drag_area_m2))

    # phases 4 and 5: the main path, Config 2, and its twin rerun

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
    launches, fused, kernel64 = run_and_rerun(42, mvn, prop21, alm, epoch, args.duration_s, gp, "main path")

    # phase 6: 70x70 JGM3 split over a quarter hour through the kernel, and its twin rerun
    launches70, fused70, _ = run_and_rerun(42, mvn, propagator_for(stor70), alm, epoch, SECONDS_70X70,
                                           gp, "70x70 path")

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

    # phase 6g: Config 3, covariance mapping and the Monte Carlo, and Config 2's Encke mode
    config3 = phase_config3(gp, SimpleNamespace(propagator=prop21, mvn=mvn, almanac=alm), kernel64)

    # phase 6h: mission design
    mission = phase_mission_design(gp, stor21)

    # phase 6i: the tracking side of OD, ex05's crosslink OD and ex06's cross-body lunar OD
    tracking = phase_tracking_od(gp)

    # phase 6j: ex03's drift bench, GTO raise, eclipse scan and raise_optim
    stor4 = GravityFieldData.from_cof(jgm3, 4, 4, True, Frames.IAU_EARTH)
    ex03 = phase_geo_ex03(gp, stor21, stor8, stor4)

    # phase 6k: the OD host loop on 6i's ex06 scene
    host_od = phase_host_od(gp, tracking)

    # phase 6l: the scan filter's modes on 6b's scene
    scan_modes = phase_scan_modes(gp, stor21, od)

    # phase 6m: the file-driven high-fidelity Earth dynamics, f32 perturbations
    hifi = phase_hifi(gp, stor21, mvn)

    # phase 6n: ensembles on a mesh of devices (every card, and shards of one card)
    mesh = phase_mesh(gp, SimpleNamespace(propagator=prop21, mvn=mvn, almanac=alm), od, stor21)

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
        "launches_encke": config3["launches_encke"],
        "encke_traj_per_s": config3["encke_traj_per_s"],
        "ex02_map_estimates_per_s": config3["map_estimates_per_s"],
        "ex02_mc_traj_per_s": config3["mc_traj_per_s"],
        "ex02_encke_traj_per_s": config3["ex02_encke_traj_per_s"],
        "launches_mission_design": mission["launches"],
        "porkchop_cells_per_s": mission["porkchop_cells_per_s"],
        "launches_ex06": tracking["launches_ex06"],
        "launches_ex06_truth": tracking["launches_ex06_truth"],
        "ex06_truth_ms_per_iter": tracking["ex06_truth_ms_per_iter"],
        "ex05_rows_per_s": tracking["ex05_rows_per_s"],
        "ex06_rows_per_s": tracking["ex06_rows_per_s"],
        "launches_ex03_drift": ex03["launches_drift"],
        "ex03_drift_days_per_min": ex03["drift_days_per_min"],
        "launches_host_od": host_od["launches"],
        "host_od_rows_per_s": host_od["rows_per_s"],
        "od_parallel_rows_per_s": scan_modes["parallel_rows_per_s"],
        "od_parallel_s4_s": scan_modes["parallel_s4"],
        "od_ensemble_filters": scan_modes["ensemble_filters"],
        "od_ensemble_wall_s": scan_modes["ensemble_wall"],
        "launches_od_ensemble": scan_modes["launches_ensemble"],
        "od_fixed_rows_per_s": scan_modes["fixed_rows_per_s"],
        "launches_hifi": hifi["launches"],
        "hifi_traj_per_s": hifi["traj_per_s"],
        "launches_mesh": mesh["launches"],
        "mesh_traj_per_s": mesh["traj_per_s"],
        "mesh_shards": mesh["shards"],
        "mesh_max_gap_km": mesh["max_gap_km"],
    }, {
        "name": "eom_pre",
        "route": "cuda",
        "source": "nyx_tpu_torch/csrc/eom.cu",
        "replaces": None,
        "launches": fused,
        "max_ulps": k3b["max_ulps"],
        "ms": k3b[B_MAIN]["pre_ms"],
        "ms_timing": "cuda_graph_replay",
        "bound_ms": k3b[B_MAIN]["pre_bound"],
        "bound_by": "bytes",
        "library_ms": None,
        f"ms_b{B_FUSED_WIDE}": k3b[B_FUSED_WIDE]["pre_ms"],
        f"bound_ms_b{B_FUSED_WIDE}": k3b[B_FUSED_WIDE]["pre_bound"],
        "launches_70x70": fused70,
    }, {
        "name": "eom_post",
        "route": "cuda",
        "source": "nyx_tpu_torch/csrc/eom.cu",
        "replaces": None,
        "launches": fused,
        "max_abs_err": k3b["max_gap"],
        "ms": k3b[B_MAIN]["post_ms"],
        "ms_timing": "cuda_graph_replay",
        "eager_ms": k3b["eager_ms"]["21x21"],
        "plain_eager_ms": k3b["plain_eager_ms"]["21x21"],
        "bound_ms": k3b[B_MAIN]["post_bound"],
        "bound_by": "bytes",
        "library_ms": None,
        f"ms_b{B_FUSED_WIDE}": k3b[B_FUSED_WIDE]["post_ms"],
        f"bound_ms_b{B_FUSED_WIDE}": k3b[B_FUSED_WIDE]["post_bound"],
        "launches_70x70": fused70,
        "eager_ms_70x70": k3b["eager_ms"]["70x70"],
        "plain_eager_ms_70x70": k3b["plain_eager_ms"]["70x70"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
