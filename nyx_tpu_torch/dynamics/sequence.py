"""Mission sequencing: a timeline of propagation phases with discrete events.

Torch port of nyx_tpu/dynamics/sequence.py:30-264 (the reference's
SpacecraftSequence, dynamics/sequence/mod.rs:48-230; Phase, PropagatorConfig
and Dynamics, config.rs:44-157; DiscreteEvent, discrete_event.rs:29-60).
The dynamics a configuration names are those the port has: point masses,
a spherical-harmonic field read from a .cof file, SRP and exponential drag;
solid tides, the 1976 standard atmosphere and EGM2008 files raise
ConfigError. The reference's Dhall loaders (sequence.py:265-473) are not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from ..cosmic.frames import Frame, Frames
from ..cosmic.spacecraft import GuidanceMode, Spacecraft, Thruster
from ..errors import ConfigError
from ..time import Epoch
from .drag import Drag
from .gravity import Harmonics
from .orbital import OrbitalDynamics, PointMasses
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
    drag: Optional[str] = None  # 'exp'

    def build(self, almanac=None) -> SpacecraftDynamics:
        models = []
        if self.point_masses:
            models.append(PointMasses(self.point_masses))
        if self.gravity_field:
            from ..io.gravity import GravityFieldData

            g = self.gravity_field
            path = str(g["path"])
            if "egm" in path.lower().rsplit("/", 1)[-1]:
                raise ConfigError("EGM2008 files are not read by the port; use a .cof field")
            stor = GravityFieldData.from_cof(path, g.get("degree", 8), g.get("order", 8),
                                             g.get("gunzipped", True), g.get("frame", Frames.IAU_EARTH))
            models.append(Harmonics.from_stor(stor, g.get("precision", "f64")))
        if self.solid_tides:
            raise ConfigError("solid tides are not ported")
        orbital = OrbitalDynamics.from_models(models, self.frame)
        forces = []
        if self.solar_pressure:
            forces.append(SolarPressure.default())
        if self.drag:
            if self.drag == "stdatm":
                raise ConfigError("the 1976 standard atmosphere is not ported; use drag='exp'")
            forces.append(Drag.earth_exp())
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
