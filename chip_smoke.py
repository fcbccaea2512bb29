#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives nyx_tpu_torch's Monte Carlo main path (Config 2 of BASELINE.md: a
10,000-lane LEO ensemble, RK89 adaptive at 1e-9, 21x21 JGM3 at split
precision, exponential drag, SRP with an Earth shadow, one day) on the card,
through the same entry points a user calls. Phases, in order; any failure
raises and exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build the Pines kernel (csrc/pines.cu) from the checkout;
3. hold the kernel against its torch twin on the card (21x21 split at
   q_lo 0 and 3, a 12x6 rectangular field; B = 10,000 and a ragged 37),
   and time both at B = 10,000 with CUDA events;
4. run the main path, after a 120 s warm-up arc, and count kernel launches;
5. rerun 64 of its lanes with the gravity twin forced and compare finals.

The second-to-last line of output is the kernels' JSON summary, the last
line `{"ok": true, "device": {...}}`. Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
B_MAIN = 10_000
B_TWIN = 64
# The reference's own f32 bound between two f32 evaluations of the
# recursion (tests/test_dynamics.py:399,415), per-lane relative norm.
KERNEL_REL_TOL = 2e-5
# Split vs full-f64 envelope over one day (tests/test_dynamics.py:304), km.
TWIN_FINAL_TOL_KM = 1e-3


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _leo_body_fixed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3))
    return r / np.linalg.norm(r, axis=1, keepdims=True) * rng.uniform(6_700.0, 7_500.0, (n, 1))


def _time_ms(fn, reps: int = 200) -> float:
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_vs_twin(gp, Harmonics, GravityFieldData, Frames):
    """Kernel vs twin on the card; returns (max_rel, max_abs, kernel_ms, twin_ms)."""
    jgm3 = HERE / "data" / "JGM3.cof.gz"
    cases = [
        (21, 21, "split", 0),
        (21, 21, "split", 3),
        (12, 6, "f32", 0),
    ]
    max_rel = max_abs = 0.0
    timed = None
    for deg, order, precision, q_lo in cases:
        h = Harmonics.from_stor(
            GravityFieldData.from_cof(jgm3, deg, order, True, Frames.IAU_EARTH), precision
        )
        tab = h.packed_table(0, torch.float32, "cuda")
        kw = h.pines_args()
        for B in (B_MAIN, 37):
            r = torch.tensor(_leo_body_fixed(B, 1000 + B), dtype=torch.float32, device="cuda")
            a_k = gp.pines_accel_cuda(r, tab, q_lo, **kw)
            a_t = gp.pines_accel_torch(r, tab, q_lo, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(a_k).all():
                raise RuntimeError(f"kernel returned non-finite values ({deg}x{order}, B={B})")
            rel = ((a_k - a_t).norm(dim=1) / a_t.norm(dim=1)).max().item()
            abs_err = (a_k - a_t).abs().max().item()
            n_diff = int((a_k != a_t).sum())
            _log(f"kernel vs twin {deg}x{order} {precision} q_lo={q_lo} B={B}: "
                 f"max rel {rel:.3e}, max abs {abs_err:.3e} km/s^2, "
                 f"{n_diff} of {a_k.numel()} values differ in any bit")
            if not rel < KERNEL_REL_TOL:
                raise RuntimeError(f"kernel disagrees with twin: rel {rel} >= {KERNEL_REL_TOL}")
            max_rel, max_abs = max(max_rel, rel), max(max_abs, abs_err)
            if (deg, precision, q_lo, B) == (21, "split", 0, B_MAIN):
                timed = (r, tab, q_lo, kw)
    r, tab, q_lo, kw = timed
    kernel_ms = _time_ms(lambda: gp.pines_accel_cuda(r, tab, q_lo, **kw))
    twin_ms = _time_ms(lambda: gp.pines_accel_torch(r, tab, q_lo, **kw))
    _log(f"21x21 split at B={B_MAIN}: kernel {kernel_ms:.4f} ms, twin {twin_ms:.4f} ms per call")
    return max_rel, max_abs, kernel_ms, twin_ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration-s", type=float, default=86_400.0,
                    help="arc of the main-path run (default: one day)")
    args = ap.parse_args()

    # phase 1: the card
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    _log(_card_line())
    device = "cuda"
    kind = torch.cuda.get_device_name(0)

    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft, _cuda
    from nyx_tpu_torch.dynamics import (
        Drag, Harmonics, OrbitalDynamics, SolarPressure, SpacecraftDynamics,
    )
    from nyx_tpu_torch.dynamics import gravity_pines as gp
    from nyx_tpu_torch.ephem import Almanac
    from nyx_tpu_torch.io import GravityFieldData
    from nyx_tpu_torch.mc import MonteCarlo, MvnSpacecraft, StateDispersion
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    # phase 2: build
    built = _cuda.load("pines")
    _log(f"built {built.path.name} in {built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            _log(f"  ptxas: {line.strip()}")

    # phase 3: kernel vs twin
    max_rel, max_abs, kernel_ms, twin_ms = phase_kernel_vs_twin(
        gp, Harmonics, GravityFieldData, Frames
    )

    # phase 4: the main path, Config 2
    epoch = Epoch.from_gregorian_utc(2021, 3, 4)
    orbit = Orbit.keplerian(7136.6, 2e-4, 51.6, 30.0, 65.0, 80.0, epoch, Frames.EME2000)
    sc = Spacecraft.new(orbit, 100.0, 0.0, 2.0, 2.0, 1.8, 2.2)
    stor = GravityFieldData.from_cof(HERE / "data" / "JGM3.cof.gz", 21, 21, True, Frames.IAU_EARTH)

    def propagator(backend):
        dyn = SpacecraftDynamics(
            OrbitalDynamics.from_model(
                Harmonics.from_stor(stor, precision="split", backend=backend), Frames.EME2000
            ),
            (SolarPressure.default(), Drag.earth_exp()),
        )
        return Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9))

    prop = propagator("auto")
    mvn = MvnSpacecraft(
        sc, [StateDispersion("sma", 0.5), StateDispersion("inc", 0.01), StateDispersion("raan", 0.01)]
    )
    mc = MonteCarlo(mvn, seed=42)
    alm = Almanac()
    end = epoch + args.duration_s
    if args.duration_s != 86_400.0:
        _log(f"NOTE: main-path arc shortened to {args.duration_s} s (not the one-day Config 2)")

    warm = mc.run_until_epoch(prop, alm, epoch + 120.0, B_MAIN, device=device)
    if warm.n_ok != warm.n_runs:
        raise RuntimeError(f"warm-up: {warm.n_ok}/{warm.n_runs} lanes ok")

    gp.pines_accel_cuda.launches = 0
    gp.pines_accel_torch.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mc.run_until_epoch(prop, alm, end, B_MAIN, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gp.pines_accel_cuda.launches
    twin_cuda_calls = gp.pines_accel_torch.cuda_calls

    mean_steps = float(np.mean(res.n_accepted))
    _log(f"main path: B={B_MAIN}, {args.duration_s} s arc, wall {wall:.3f} s, "
         f"{res.n_ok / wall:.2f} traj/s, mean accepted steps {mean_steps:.2f}, "
         f"mean rejected {float(np.mean(res.n_rejected)):.2f}, "
         f"n_ok/n_runs {res.n_ok}/{res.n_runs}, kernel launches {launches}, "
         f"twin CUDA calls {twin_cuda_calls}")
    if res.n_ok != res.n_runs:
        raise RuntimeError(f"{res.n_ok}/{res.n_runs} lanes ok")
    if res.y_final.shape != (B_MAIN, 9) or not np.isfinite(res.y_final).all():
        raise RuntimeError("final states are not finite [B, 9]")
    if launches <= 0 or twin_cuda_calls != 0:
        raise RuntimeError(
            f"main path did not run through the kernel: {launches} launches, "
            f"{twin_cuda_calls} twin calls on CUDA"
        )

    # phase 5: the same 64 lanes with the gravity twin forced
    twin = MonteCarlo(mvn, seed=42).run_until_epoch(
        propagator("torch"), alm, end, B_TWIN, device=device, _y0=res.y_initial[:B_TWIN]
    )
    if twin.n_ok != B_TWIN:
        raise RuntimeError(f"twin rerun: {twin.n_ok}/{B_TWIN} lanes ok")
    d_km = np.linalg.norm(twin.y_final[:, :3] - res.y_final[:B_TWIN, :3], axis=1).max()
    _log(f"twin rerun of {B_TWIN} lanes: max final position difference {d_km:.3e} km, "
         f"mean accepted steps {float(np.mean(twin.n_accepted)):.2f} vs "
         f"{float(np.mean(res.n_accepted[:B_TWIN])):.2f}")
    if not d_km < TWIN_FINAL_TOL_KM:
        raise RuntimeError(f"kernel and twin runs differ by {d_km} km >= {TWIN_FINAL_TOL_KM}")

    # phase 6: summary
    print(json.dumps({"kernels": [{
        "name": "pines_accel",
        "route": "cuda",
        "source": "nyx_tpu_torch/csrc/pines.cu",
        "replaces": "nyx_tpu/dynamics/gravity_pallas.py:71",
        "launches": launches,
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
