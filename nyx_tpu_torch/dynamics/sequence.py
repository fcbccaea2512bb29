"""Mission sequencing: a timeline of propagation phases with discrete events.

Torch port of nyx_tpu/dynamics/sequence.py:30-264 (the reference's
SpacecraftSequence, dynamics/sequence/mod.rs:48-230; Phase, PropagatorConfig
and Dynamics, config.rs:44-157; DiscreteEvent, discrete_event.rs:29-60).
A configuration names point masses, a spherical-harmonic field read from
a .cof or (by its file name) an EGM2008 file, solid tides, SRP, and
exponential or 1976 standard-atmosphere drag. Propagators and whole
sequences also load from Dhall documents
(`load_dhall_propagator`, `load_dhall_sequence`; the reference's
sequence.py:265-473, parsed by `io/dhall.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..cosmic.frames import Frame, Frames
from ..cosmic.spacecraft import GuidanceMode, Spacecraft, Thruster
from ..errors import ConfigError
from ..time import Epoch
from .drag import Drag
from .gravity import Harmonics
from .orbital import OrbitalDynamics, PointMasses
from .solid_tides import SolidTides
from .spacecraft_dyn import SpacecraftDynamics
from .srp import SolarPressure


@dataclass
class PhysicalProperties:
    """Mass, SRP and drag deltas applied by staging or docking
    (discrete_event.rs:44-60)."""

    dry_mass_kg: float = 0.0
    prop_mass_kg: float = 0.0
    srp_area_m2: float = 0.0
    drag_area_m2: float = 0.0


@dataclass
class DiscreteEvent:
    """A one-shot state change on a phase's entry (discrete_event.rs:29-43).

    kind: 'staging' (subtracts the properties), 'docking' (adds them),
    'frame_swap' (moves the state to `new_frame`, translating it through the
    almanac when the centre changes)."""

    kind: str
    impulsive_maneuver: Optional[object] = None  # ImpulsiveManeuver
    properties: Optional[PhysicalProperties] = None
    new_frame: Optional[Frame] = None

    def apply(self, state: Spacecraft, almanac=None) -> Spacecraft:
        if self.kind == "frame_swap":
            if self.new_frame is None:
                raise ConfigError("frame_swap needs new_frame")
            if self.new_frame.center == state.frame.center:
                return state.with_orbit(replace(state.orbit, frame=self.new_frame))
            if almanac is None:
                raise ConfigError("frame_swap across centers needs an almanac")
            return state.with_orbit(almanac.translate_to(state.orbit, self.new_frame))
        if self.impulsive_maneuver is not None:
            state = self.impulsive_maneuver.apply(state)
        if self.properties is not None:
            sign = -1.0 if self.kind == "staging" else 1.0
            p = self.properties
            state = replace(
                state,
                dry_mass_kg=state.dry_mass_kg + sign * p.dry_mass_kg,
                prop_mass_kg=state.prop_mass_kg + sign * p.prop_mass_kg,
                srp_area_m2=state.srp_area_m2 + sign * p.srp_area_m2,
                drag_area_m2=state.drag_area_m2 + sign * p.drag_area_m2,
            )
        return state


@dataclass
class DynamicsConfig:
    """Declarative dynamics (config.rs Dynamics/AccelModels/ForceModels)."""

    frame: Frame = Frames.EME2000
    point_masses: Tuple[int, ...] = ()
    gravity_field: Optional[dict] = None  # {path, degree, order, gunzipped, frame, precision}
    solid_tides: bool = False
    solar_pressure: bool = False
    drag: Optional[str] = None  # 'exp' | 'stdatm' (any other value: 'exp', as the reference)

    def build(self, almanac=None) -> SpacecraftDynamics:
        models = []
        if self.point_masses:
            models.append(PointMasses(self.point_masses))
        if self.gravity_field:
            from ..io.gravity import GravityFieldData

            g = self.gravity_field
            path = str(g["path"])
            loader = (GravityFieldData.from_egm2008 if "egm" in path.lower().rsplit("/", 1)[-1]
                      else GravityFieldData.from_cof)
            stor = loader(path, g.get("degree", 8), g.get("order", 8),
                          g.get("gunzipped", True), g.get("frame", Frames.IAU_EARTH))
            models.append(Harmonics.from_stor(stor, g.get("precision", "f64")))
        if self.solid_tides:
            models.append(SolidTides.earth_moon_system())
        orbital = OrbitalDynamics.from_models(models, self.frame)
        forces = []
        if self.solar_pressure:
            forces.append(SolarPressure.default())
        if self.drag:
            forces.append(Drag.std_atm1976() if self.drag == "stdatm" else Drag.earth_exp())
        return SpacecraftDynamics.from_models(orbital, forces)


@dataclass
class PropagatorConfig:
    """Dynamics, integrator method and options (config.rs:102-133)."""

    dynamics: DynamicsConfig
    method: str = "rk89"
    options: Optional[object] = None  # IntegratorOptions

    def build(self, almanac=None):
        from ..propagators import IntegratorOptions, Propagator

        return Propagator.from_method(self.dynamics.build(almanac), self.method,
                                      self.options or IntegratorOptions())


@dataclass
class Phase:
    """A timeline entry (config.rs:44-55)."""

    name: str = ""
    propagator: str = ""
    guidance: Optional[dict] = None  # {'law': GuidanceLaw, 'thruster_model': str}
    on_entry: Optional[DiscreteEvent] = None
    disabled: bool = False
    terminate: bool = False

    @classmethod
    def Terminate(cls) -> "Phase":
        return cls(terminate=True)

    @classmethod
    def Activity(cls, name, propagator, guidance=None, on_entry=None, disabled=False) -> "Phase":
        return cls(name, propagator, guidance, on_entry, disabled)


@dataclass
class SpacecraftSequence:
    """A timeline of phases (sequence/mod.rs:48-120)."""

    seq: Dict[Epoch, Phase]
    thruster_sets: Dict[str, Thruster] = field(default_factory=dict)
    propagators: Dict[str, PropagatorConfig] = field(default_factory=dict)

    def _sorted(self) -> List[Tuple[Epoch, Phase]]:
        return sorted(self.seq.items(), key=lambda kv: kv[0].to_tai_seconds())

    def validate(self):
        items = self._sorted()
        if not items or not items[-1][1].terminate:
            raise ConfigError("final phase must be a Terminate")
        for epoch, phase in items:
            if phase.terminate:
                continue
            if phase.propagator not in self.propagators:
                raise ConfigError(f"{epoch}: no propagator named `{phase.propagator}`")
            if phase.guidance is not None:
                thruster = phase.guidance.get("thruster_model")
                if thruster not in self.thruster_sets:
                    raise ConfigError(f"{epoch}: no thruster set named {thruster}")

    def setup(self, almanac=None):
        """Validate, then build each propagator the enabled phases name."""
        self.validate()
        self._built = {}
        for _, phase in self._sorted():
            if not phase.terminate and not phase.disabled and phase.propagator not in self._built:
                self._built[phase.propagator] = self.propagators[phase.propagator].build(almanac)

    def propagate(self, state: Spacecraft, until_phase: Optional[str] = None, almanac=None, *,
                  device="cuda") -> List:
        """Run the timeline on `device` from the state's epoch; one
        Trajectory per phase run (sequence/mod.rs:120-230). Each phase runs
        to the next entry's epoch; `until_phase` stops before the phase of
        that name."""
        if not hasattr(self, "_built"):
            self.setup(almanac)
        items = [(e, p) for e, p in self._sorted()
                 if e.to_tai_seconds() >= state.epoch.to_tai_seconds() - 1e-9]
        trajs = []
        for i, (epoch, phase) in enumerate(items):
            if phase.terminate or (until_phase is not None and phase.name == until_phase):
                break
            if phase.disabled:
                continue
            if phase.on_entry is not None:
                state = phase.on_entry.apply(state, almanac)
            prop = self._built[phase.propagator]
            if phase.guidance is not None:
                prop = prop.with_guidance(phase.guidance["law"])
                state = replace(state, thruster=self.thruster_sets[phase.guidance["thruster_model"]],
                                mode=GuidanceMode.Thrust)
            else:
                state = replace(state, mode=GuidanceMode.Coast)
            state, traj = prop.with_state(state, almanac, device=device).until_epoch_with_traj(items[i + 1][0])
            trajs.append(traj)
        return trajs


# ---------------------------------------------------------------------------
# Dhall front-end (the reference's serde_dhall configs, config.rs:57-133):
# io/dhall.py parses a document into dicts, lists and scalars; the loaders
# below map those trees onto the dataclasses above.
# ---------------------------------------------------------------------------
_DHALL_METHODS = {
    "RungeKutta89": "rk89",
    "DormandPrince78": "dp78",
    "DormandPrince45": "dp45",
    "CashKarp45": "ck45",
    "RungeKutta4": "rk4",
    "Verner56": "verner56",
}

#: StateParameter / OrbitalElement union tags -> the port's parameter names
_DHALL_PARAMS = {
    "SemiMajorAxis": "sma",
    "Eccentricity": "ecc",
    "Inclination": "inc",
    "RAAN": "raan",
    "AoP": "aop",
    "TrueAnomaly": "ta",
    "AoL": "aol",
    "ApoapsisRadius": "apoapsis_radius",
    "PeriapsisRadius": "periapsis_radius",
    "Cr": "cr",
    "Cd": "cd",
    "DryMass": "dry_mass_kg",
    "PropMass": "prop_mass_kg",
    "BdotR": "b_dot_r",
    "BdotT": "b_dot_t",
    "BLTOF": "b_ltof",
}


def _dhall_frame(d) -> Frame:
    from ..io.config import _frame_from_cfg

    return _frame_from_cfg(d)


def _dhall_options(d):
    from ..io.config import parse_duration_s
    from ..propagators import IntegratorOptions
    from ..propagators.error_ctrl import ErrorControl

    return IntegratorOptions(
        init_step_s=parse_duration_s(d.get("init_step", 60.0)),
        min_step_s=parse_duration_s(d.get("min_step", 1e-3)),
        max_step_s=parse_duration_s(d.get("max_step", 2700.0)),
        tolerance=float(d.get("tolerance", 1e-12)),
        attempts=int(d.get("attempts", 50)),
        fixed_step=bool(d.get("fixed_step", False)),
        error_ctrl=getattr(ErrorControl, d.get("error_ctrl", "RSSCartesianStep")),
    )


def _dhall_dynamics(d) -> DynamicsConfig:
    """Point masses, a gravity field ({_1: file spec, _2: frame}), drag by
    its density's tag (constant, exponential or the 1976 atmosphere) and
    SRP, as `DynamicsConfig.build` then assembles them."""
    accel = d.get("accel_models", {})
    force = d.get("force_models", {})
    cfg = DynamicsConfig()
    pm = accel.get("point_masses")
    if pm:
        cfg.point_masses = tuple(int(b) for b in pm.get("celestial_objects", ()))
    gf = accel.get("gravity_field")
    if gf:
        spec, frame = gf["_1"], gf["_2"]
        cfg.gravity_field = {
            "path": spec["filepath"],
            "degree": int(spec["degree"]),
            "order": int(spec["order"]),
            "gunzipped": bool(spec.get("gunzipped", False)),
            "frame": _dhall_frame(frame),
        }
    drag = force.get("drag")
    if drag:
        density = drag.get("density")
        tag = density.get("_tag") if isinstance(density, dict) else str(density)
        cfg.drag = {"Constant": "constant", "Exponential": "exp", "StdAtm": "stdatm"}.get(tag, "exp")
    if force.get("solar_pressure") is not None:
        cfg.solar_pressure = True
    return cfg


def propagator_config_from_dhall(d: dict) -> PropagatorConfig:
    """One propagator document (prop_config.dhall, config.rs:102-133)."""
    return PropagatorConfig(
        dynamics=_dhall_dynamics(d),
        method=_DHALL_METHODS.get(d.get("method", "RungeKutta89"), "rk89"),
        options=_dhall_options(d.get("options", {})),
    )


def load_dhall_propagator(path) -> PropagatorConfig:
    from ..io import dhall

    return propagator_config_from_dhall(dhall.load(path))


def _dhall_poly(d) -> np.ndarray:
    """CommonPolynomial union -> most-significant-first coefficients."""
    tag = d["_tag"]
    if tag == "Constant":
        return np.array([d["a"]])
    if tag == "Linear":
        return np.array([d["b"], d["a"]])
    if tag == "Quadratic":
        return np.array([d["c"], d["b"], d["a"]])
    raise ConfigError(f"unsupported polynomial {tag}")


def _dhall_guidance_law(d):
    """A FiniteBurn (a time-invariant vector or azimuth and elevation
    polynomials in a local frame) or a Kluever law with its objectives."""
    from ..md.objective import Objective
    from .guidance import Kluever, LocalFrame, Maneuver

    tag = d.get("_tag")
    if tag == "FiniteBurn":
        frame = getattr(LocalFrame, d.get("frame", "VNC"), LocalFrame.VNC)
        start, end = Epoch.from_str(d["start"]), Epoch.from_str(d["end"])
        rep = d["representation"]
        if rep.get("_tag") == "Vector":
            return Maneuver.from_time_invariant(
                start, end, float(d.get("thrust_prct", 1.0)),
                np.array([rep["_1"], rep["_2"], rep["_3"]]), frame)
        return Maneuver(start, end, float(d.get("thrust_prct", 1.0)),
                        azimuth_poly=_dhall_poly(rep["azimuth"]),
                        elevation_poly=_dhall_poly(rep["elevation"]), frame=frame)
    if tag == "Kluever":
        objectives = []
        for entry in d.get("objectives", ()):
            o = entry["objective"]
            p = o["parameter"]
            if isinstance(p, dict):  # Element : <OrbitalElement>
                p = p.get("_value", p.get("_tag"))
            objectives.append(Objective(
                parameter=_DHALL_PARAMS.get(str(p), str(p).lower()),
                desired_value=float(o["desired_value"]),
                tolerance=float(o.get("tolerance", 0.1)),
                multiplicative_factor=float(o.get("multiplicative_factor", 1.0)),
                additive_factor=float(o.get("additive_factor", 0.0)),
            ))
        weights = tuple(1.0 for _ in objectives)
        if d.get("max_eclipse_prct") is not None:
            return Kluever.from_max_eclipse(tuple(objectives), weights,
                                            float(d["max_eclipse_prct"]))
        return Kluever.new(tuple(objectives), weights)
    raise ConfigError(f"unsupported guidance law {tag}")


def _dhall_properties(d) -> PhysicalProperties:
    mass = d.get("mass") or {}
    srp = d.get("srp") or {}
    drag = d.get("drag") or {}
    return PhysicalProperties(
        dry_mass_kg=float(mass.get("dry_mass_kg", 0.0)) + float(mass.get("extra_mass_kg", 0.0)),
        prop_mass_kg=float(mass.get("prop_mass_kg", 0.0)),
        srp_area_m2=float(srp.get("area_m2", 0.0)),
        drag_area_m2=float(drag.get("area_m2", 0.0)),
    )


def _dhall_impulsive(d):
    from .guidance import ImpulsiveManeuver, LocalFrame

    dv = d["dv_km_s"]
    return ImpulsiveManeuver(
        dv_km_s=np.array([dv["_1"], dv["_2"], dv["_3"]]),
        local_frame=getattr(LocalFrame, d.get("local_frame", "VNC"), LocalFrame.VNC),
    )


def _dhall_on_entry(d) -> DiscreteEvent:
    tag = d.get("_tag") if isinstance(d, dict) else str(d)
    if tag == "FrameSwap":
        return DiscreteEvent("frame_swap", new_frame=_dhall_frame(d["new_frame"]))
    if tag in ("Staging", "Docking"):
        key = "decrement_properties" if tag == "Staging" else "increment_properties"
        props = d.get(key)
        mnv = d.get("impulsive_maneuver")
        return DiscreteEvent(
            tag.lower(),
            impulsive_maneuver=_dhall_impulsive(mnv) if mnv else None,
            properties=_dhall_properties(props) if props else None,
        )
    raise ConfigError(f"unsupported discrete event {tag}")


def _dhall_phase(d) -> Phase:
    tag = d.get("_tag") if isinstance(d, dict) else str(d)
    if tag == "Terminate":
        return Phase.Terminate()
    if tag != "Activity":
        raise ConfigError(f"unsupported phase {tag}")
    guidance = None
    if d.get("guidance") is not None:
        g = d["guidance"]
        guidance = {
            "law": _dhall_guidance_law(g["law"]),
            "thruster_model": g.get("thruster_model", ""),
            "disable_prop_mass": bool(g.get("disable_prop_mass", False)),
        }
    on_entry = _dhall_on_entry(d["on_entry"]) if d.get("on_entry") else None
    return Phase.Activity(d.get("name", ""), d.get("propagator", ""), guidance, on_entry,
                          bool(d.get("disabled", False)))


def sequence_from_dhall(d: dict) -> SpacecraftSequence:
    """A whole sequence document (full_seq.dhall, sequence/mod.rs:48-120):
    the timeline as (epoch, phase) pairs, the thruster sets and the
    propagators by name."""
    seq = {Epoch.from_str(pair["_1"]): _dhall_phase(pair["_2"]) for pair in d.get("seq", ())}
    thrusters = {
        pair["_1"]: Thruster(thrust_N=float(pair["_2"]["thrust_N"]),
                             isp_s=float(pair["_2"]["isp_s"]))
        for pair in d.get("thruster_sets", ())
    }
    props = {pair["_1"]: propagator_config_from_dhall(pair["_2"])
             for pair in d.get("propagators", ())}
    return SpacecraftSequence(seq=seq, thruster_sets=thrusters, propagators=props)


def load_dhall_sequence(path) -> SpacecraftSequence:
    from ..io import dhall

    return sequence_from_dhall(dhall.load(path))
