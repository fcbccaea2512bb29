#!/usr/bin/env python
"""The reference's own two filters on ex06's scene: how far apart they end.

Runs nyx_tpu (JAX, on the CPU, float64) on examples/06_lunar_od.py's scene
with its field at a given degree and split precision: the 1 h truth, the
Earth stations from chip_smoke.ex06_scene's YAML each with its offset table
to the Moon, the noisy arc (seed 123) cut to its first 30 min, and from the
randomized start (rng 123) both the host loop (`KalmanODProcess`, the EKF
with the SNC and the 3-sigma gate, the example's NYX_EX06_HOST branch) and
the scan EKF (`ScanKalmanOD`, stm_jvp_degree 8, segment_rows 8, the
example's device path). Prints both filters' counts and the distance
between their final position estimates, km. chip_smoke.py's phase 6k holds
the port's host loop to the scan EKF within 1.1 times this gap at degree 50
(EX06_HOST_SCAN_KM).

    python devtools/ex06_filter_gap.py 50     # ~75 s on a CPU
"""

import importlib.util
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import nyx_tpu as R  # noqa: E402
from nyx_tpu.constants import NAIF  # noqa: E402
from nyx_tpu.dynamics import (  # noqa: E402
    Harmonics, OrbitalDynamics, PointMasses, SolarPressure, SpacecraftDynamics,
)
from nyx_tpu.ephem.almanac import Almanac  # noqa: E402
from nyx_tpu.io.config import load_trk_configs  # noqa: E402
from nyx_tpu.od import (  # noqa: E402
    GroundStation, KalmanODProcess, KalmanVariant, MeasurementType, ProcessNoise,
    SpacecraftUncertainty, TrackingArcSim, TrackingDataArc,
)
from nyx_tpu.od.scan_filter import ScanKalmanOD  # noqa: E402
from nyx_tpu.propagators import IntegratorOptions, Propagator  # noqa: E402


def main(degree: int) -> None:
    spec = importlib.util.spec_from_file_location("ex06", ROOT / "examples/06_lunar_od.py")
    ex06 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex06)
    yaml_dir = Path(tempfile.mkdtemp(prefix="ex06_gap_"))
    chip_smoke.ex06_scene(chip_smoke.ex06_moon_field(8), "f64", yaml_dir=yaml_dir, device="cpu")

    alm = Almanac()
    moon = R.Frames.MOON_J2000
    epoch = R.Epoch.from_gregorian_utc(2024, 2, 29, 12, 0, 0.0)
    orbiter = R.Spacecraft.new(R.Orbit.keplerian(1737.4 + 150.0, 0.00212, 33.6, 45.0, 45.0, 0.0, epoch, moon),
                               1018.0, 900.0, 3.9 * 2.7, 0.0, 0.96, 2.2)
    dyn = SpacecraftDynamics(OrbitalDynamics.from_models(
        [Harmonics.from_stor(ex06.kaula_moon_field(degree), precision="split"),
         PointMasses((NAIF.EARTH, NAIF.SUN, NAIF.JUPITER_BARYCENTER))], moon),
        (SolarPressure.default(NAIF.MOON),))
    setup = Propagator.rk89(dyn, IntegratorOptions(tolerance=1e-10, max_step_s=60.0))
    _, traj = setup.with_state(orbiter, alm).for_duration_with_traj(3600.0)
    devices = GroundStation.load_named(yaml_dir / "dsn-network.yaml")
    configs = load_trk_configs(yaml_dir / "tracking-cfg.yaml")
    stations = [g.with_target_frame(alm, NAIF.MOON, epoch, epoch + 3600.0) for g in devices.values()]
    arc = TrackingArcSim.with_seed(stations, traj, configs, seed=123).generate_measurements()
    keep = arc.epochs_tai_s < arc.epochs_tai_s[0] + 1800.0
    head = TrackingDataArc(arc.trackers, arc.types, arc.epochs_tai_s[keep], arc.tracker_idx[keep],
                           arc.values[keep])
    unc = SpacecraftUncertainty(nominal=orbiter, frame="ric", x_km=0.5, y_km=0.5, z_km=0.5,
                                vx_km_s=5e-3, vy_km_s=5e-3, vz_km_s=5e-3)
    est0, dispersed = unc.to_estimate_randomized(np.random.default_rng(123))
    est0 = replace(est0, nominal=dispersed)
    snc = ProcessNoise.from_velocity_km_s([1e-14] * 3, 3600.0, disable_time_s=600.0)

    t0 = time.time()
    scan = ScanKalmanOD(setup, stations, types=(MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S),
                        variant="ekf", process_noise=(snc,), resid_rejection_sigmas=3.0, almanac=alm,
                        stm_jvp_degree=8, segment_rows=8).process_arc(est0, head)
    t1 = time.time()
    host = KalmanODProcess(setup, process_noise=(snc,), variant=KalmanVariant.ReferenceUpdate,
                           resid_rejection_sigmas=3.0, almanac=alm).process_arc(est0, head, stations)
    t2 = time.time()
    gap = float(np.linalg.norm(np.asarray(host.final_estimate.state().to_vector())[:3]
                               - np.asarray(scan.y_est)[len(head) - 1, :3]))
    print(f"degree {degree}, {len(head)} rows: scan EKF {t1 - t0:.1f} s, "
          f"{len(head) - int(np.sum(scan.rejected))} accepted; host loop {t2 - t1:.1f} s, {host.accepted} "
          f"accepted, {host.rejected} rejected; final positions {gap:.6e} km apart")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 50)
