"""The program's objects for one configuration file.

A frozen copy of the scene of `bench.py`'s Config 2 (the LEO spacecraft,
its dispersions, the JGM-3 field, SRP with the Earth's shadow, exponential
drag, RK89 between GMAT's step bounds) built through `nyx_tpu_torch`'s
public API, with every number read from the configuration file. The
program is imported here, inside the function, never at module import.
"""

from __future__ import annotations

import datetime as _dt
from pathlib import Path
from types import SimpleNamespace


def build(cfg: dict, root: Path, seed: int) -> SimpleNamespace:
    """(mc, prop, almanac, epoch, template, field) of the configuration."""
    from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft
    from nyx_tpu_torch.dynamics import (Drag, Harmonics, OrbitalDynamics, SolarPressure,
                                        SpacecraftDynamics)
    from nyx_tpu_torch.ephem.almanac import Almanac
    from nyx_tpu_torch.io.gravity import GravityFieldData
    from nyx_tpu_torch.mc import MonteCarlo, MvnSpacecraft, StateDispersion
    from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

    t = _dt.datetime.fromisoformat(cfg["epoch_utc"])
    epoch = Epoch.from_gregorian_utc(t.year, t.month, t.day, t.hour, t.minute,
                                     t.second + t.microsecond / 1e6)
    frame = getattr(Frames, cfg["frame"])
    o, sc = cfg["orbit"], cfg["spacecraft"]
    orbit = Orbit.keplerian(o["sma_km"], o["ecc"], o["inc_deg"], o["raan_deg"], o["aop_deg"],
                            o["ta_deg"], epoch, frame)
    template = Spacecraft.new(orbit, sc["dry_mass_kg"], sc["prop_mass_kg"], sc["srp_area_m2"],
                              sc["drag_area_m2"], sc["cr"], sc["cd"])
    f = cfg["field"]
    stor = GravityFieldData.from_cof(root / f["file"], f["degree"], f["order"], True,
                                     getattr(Frames, f["body_frame"]))
    dynamics = SpacecraftDynamics(
        OrbitalDynamics.from_model(Harmonics.from_stor(stor, precision=f["precision"]), frame),
        (SolarPressure.default(), Drag.earth_exp()),
    )
    ic = cfg["integrator"]
    opts = IntegratorOptions.with_adaptive_step(ic["min_step_s"], ic["max_step_s"], ic["tolerance"])
    prop = getattr(Propagator, ic["method"].lower())(dynamics, opts)
    mvn = MvnSpacecraft(template, [StateDispersion(n, s) for n, s in cfg["dispersions"]])
    return SimpleNamespace(mc=MonteCarlo(mvn, seed=seed), prop=prop, almanac=Almanac(),
                           epoch=epoch, template=template, field=(f["degree"], f["order"]))
