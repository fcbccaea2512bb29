"""YAML and TOML configuration documents.

Port of nyx_tpu/io/config.py: durations ("1 min", "24 h"), frames by name
or NAIF ids, noise models, `GroundStation` documents (one, a list, or a
named map), `Spacecraft` documents, `TrkConfig` documents (one, or a named
map) and `IntegratorOptions` documents, with the reference's field names.
Both formats are read (TOML by `tomllib`) and written (TOML by the small
emitter `toml_dumps`: scalars, arrays, tables and arrays of tables, which
is all these documents hold).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import yaml

from ..constants import NAIF
from ..cosmic.frames import Frame, Frames
from ..cosmic.orbit import Orbit
from ..cosmic.spacecraft import Spacecraft, Thruster
from ..errors import ConfigError
from ..time import Epoch

_DUR_UNITS = {
    "s": 1.0, "sec": 1.0, "second": 1.0, "seconds": 1.0,
    "min": 60.0, "minute": 60.0, "minutes": 60.0,
    "h": 3600.0, "hour": 3600.0, "hours": 3600.0,
    "d": 86400.0, "day": 86400.0, "days": 86400.0,
    "ms": 1e-3,
}


def parse_duration_s(v) -> Optional[float]:
    """'1 min' / '24 h' / '10 s' / a number -> seconds."""
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    parts = str(v).split()
    if len(parts) == 1:
        return float(parts[0])
    return sum(float(num) * _DUR_UNITS[unit.lower()] for num, unit in zip(parts[::2], parts[1::2]))


def _frame_from_cfg(cfg) -> Frame:
    """A frame from its name ('EME2000', 'IAU_EARTH') or an
    {ephemeris_id, orientation_id} map (orientation 0: J2000-aligned)."""
    if cfg is None:
        return Frames.IAU_EARTH
    if isinstance(cfg, str):
        return getattr(Frames, cfg.upper().replace(" ", "_"))
    eph = int(cfg.get("ephemeris_id", NAIF.EARTH))
    orient = int(cfg.get("orientation_id", eph))
    if orient == 0:
        by_center = {NAIF.EARTH: Frames.EME2000, NAIF.MOON: Frames.MOON_J2000}
    else:
        by_center = {NAIF.EARTH: Frames.IAU_EARTH, NAIF.MOON: Frames.IAU_MOON}
    if eph in by_center:
        return by_center[eph]
    raise ConfigError(f"unsupported frame config {cfg}")


def _noise_from_cfg(cfg):
    from ..od.noise import GaussMarkov, StochasticNoise, WhiteNoise

    white = bias = None
    if cfg:
        if cfg.get("white_noise") is not None:
            white = WhiteNoise(float(cfg["white_noise"].get("sigma", 0.0)))
        if cfg.get("bias") is not None:
            bias = GaussMarkov(tau_s=parse_duration_s(cfg["bias"].get("tau", 86400.0)),
                               process_noise=float(cfg["bias"].get("process_noise", 0.0)))
    return StochasticNoise(white_noise=white, bias=bias)


def ground_station_from_dict(d: dict):
    """A GroundStation from its document; the elevation mask is the largest
    of its terrain mask's entries unless `elevation_mask_deg` is given."""
    from ..od.ground_station import GroundStation

    loc = d.get("location", d)
    elevation_mask = 0.0
    for entry in loc.get("terrain_mask") or []:
        elevation_mask = max(elevation_mask, float(entry.get("elevation_mask_deg", 0.0)))
    if "elevation_mask_deg" in d:
        elevation_mask = float(d["elevation_mask_deg"])
    gs = GroundStation(
        name=d["name"],
        latitude_deg=float(loc["latitude_deg"]),
        longitude_deg=float(loc["longitude_deg"]),
        height_km=float(loc["height_km"]),
        frame=_frame_from_cfg(loc.get("frame")),
        elevation_mask_deg=elevation_mask,
        measurement_types=tuple(d.get("measurement_types", ("range_km", "doppler_km_s"))),
        integration_time_s=parse_duration_s(d.get("integration_time")),
        light_time_correction=bool(d.get("light_time_correction", False)),
    )
    gs.stochastic_noises = {mtype: _noise_from_cfg(cfg)
                            for mtype, cfg in (d.get("stochastic_noises") or {}).items()}
    return gs


def load_ground_stations(path) -> List:
    """Stations from a YAML or TOML document: one, a list (TOML: a
    `[[stations]]` array of tables) or a named map {alias: station}."""
    doc = _load_any(path)
    if isinstance(doc, dict) and isinstance(doc.get("stations"), list):
        doc = doc["stations"]
    if isinstance(doc, dict):
        if "name" not in doc and all(isinstance(v, dict) for v in doc.values()):
            doc = [dict(v, name=v.get("name", k)) for k, v in doc.items()]
        else:
            doc = [doc]
    return [ground_station_from_dict(d) for d in doc]


def ground_station_to_dict(gs) -> dict:
    out = {
        "name": gs.name,
        "location": {
            "latitude_deg": gs.latitude_deg,
            "longitude_deg": gs.longitude_deg,
            "height_km": gs.height_km,
            "frame": {"ephemeris_id": gs.frame.center, "orientation_id": gs.frame.center},
            "terrain_mask": [{"azimuth_deg": 0.0, "elevation_mask_deg": gs.elevation_mask_deg}],
        },
        "measurement_types": list(gs.measurement_types),
        "light_time_correction": gs.light_time_correction,
    }
    if gs.integration_time_s:
        out["integration_time"] = f"{gs.integration_time_s} s"
    noises = {}
    for mtype, n in gs.stochastic_noises.items():
        entry = {}
        if n.white_noise is not None:
            entry["white_noise"] = {"sigma": n.white_noise.sigma}
        if n.bias is not None:
            entry["bias"] = {"tau": f"{n.bias.tau_s} s", "process_noise": n.bias.process_noise}
        noises[mtype] = entry
    if noises:
        out["stochastic_noises"] = noises
    return out


def save_ground_stations(stations, path) -> str:
    """YAML: one station as a document, several as a list; TOML: a
    `[[stations]]` array of tables."""
    doc = [ground_station_to_dict(g) for g in stations]
    if str(path).endswith(".toml"):
        return _save_any({"stations": doc}, path)
    return _save_any(doc if len(doc) > 1 else doc[0], path)


def spacecraft_from_dict(d: dict) -> Spacecraft:
    """A Spacecraft from its document: a Cartesian orbit with its epoch
    and frame, mass (dry plus extra, propellant), SRP, drag and an
    optional thruster."""
    o = d["orbit"]
    orbit = Orbit.cartesian(
        float(o["x_km"]), float(o["y_km"]), float(o["z_km"]),
        float(o["vx_km_s"]), float(o["vy_km_s"]), float(o["vz_km_s"]),
        Epoch.from_str(str(o["epoch"])), _frame_from_cfg(o.get("frame", "EME2000")))
    mass, srp, drag = d.get("mass", {}), d.get("srp", {}), d.get("drag", {})
    thruster = None
    if d.get("thruster"):
        thruster = Thruster(thrust_N=float(d["thruster"]["thrust_N"]),
                            isp_s=float(d["thruster"]["isp_s"]))
    return Spacecraft(
        orbit=orbit,
        dry_mass_kg=float(mass.get("dry_mass_kg", 0.0)) + float(mass.get("extra_mass_kg", 0.0)),
        prop_mass_kg=float(mass.get("prop_mass_kg", 0.0)),
        srp_area_m2=float(srp.get("area_m2", 0.0)),
        cr=float(srp.get("coeff_reflectivity", 1.8)),
        drag_area_m2=float(drag.get("area_m2", 0.0)),
        cd=float(drag.get("coeff_drag", 2.2)),
        thruster=thruster,
    )


def load_spacecraft(path) -> Spacecraft:
    return spacecraft_from_dict(_load_any(path))


def spacecraft_to_dict(sc: Spacecraft) -> dict:
    """The document of `spacecraft_from_dict`; the frame is written by name,
    EME2000 for an inertial frame and IAU_EARTH otherwise, as the
    reference does, and the epoch in UTC."""
    o = sc.orbit
    out = {
        "orbit": {
            "x_km": float(o.r_km[0]), "y_km": float(o.r_km[1]), "z_km": float(o.r_km[2]),
            "vx_km_s": float(o.v_km_s[0]), "vy_km_s": float(o.v_km_s[1]),
            "vz_km_s": float(o.v_km_s[2]),
            "frame": "EME2000" if o.frame.is_inertial else "IAU_EARTH",
            "epoch": o.epoch.isoformat("UTC"),
        },
        "mass": {"dry_mass_kg": sc.dry_mass_kg, "prop_mass_kg": sc.prop_mass_kg,
                 "extra_mass_kg": 0.0},
        "srp": {"coeff_reflectivity": sc.cr, "area_m2": sc.srp_area_m2},
        "drag": {"coeff_drag": sc.cd, "area_m2": sc.drag_area_m2},
    }
    if sc.thruster is not None:
        out["thruster"] = {"thrust_N": sc.thruster.thrust_N, "isp_s": sc.thruster.isp_s}
    return out


def save_spacecraft(sc: Spacecraft, path) -> str:
    return _save_any(spacecraft_to_dict(sc), path)


def trk_config_from_dict(d: dict):
    from ..od.simulator import Scheduler, TrkConfig

    sched = None
    if d.get("scheduler") is not None:
        s = d["scheduler"]
        sched = Scheduler(
            handoff=str(s.get("handoff", "eager")).lower(),
            cadence=str(s.get("cadence", "continuous")).lower(),
            min_samples=int(s.get("min_samples", 10)),
            sample_alignment_s=parse_duration_s(s.get("sample_alignment")),
        )
    strands = None
    if d.get("strands"):
        strands = [(Epoch.from_str(str(e["start"])), Epoch.from_str(str(e["end"])))
                   for e in d["strands"]]
    return TrkConfig(sampling_s=parse_duration_s(d.get("sampling", 60.0)), scheduler=sched,
                     strands=strands)


def load_trk_configs(path) -> Dict[str, object]:
    """A named map {device: config}, or one document (under the name "")."""
    doc = _load_any(path)
    if "sampling" in doc or "scheduler" in doc:
        return {"": trk_config_from_dict(doc)}
    return {name: trk_config_from_dict(d) for name, d in doc.items()}


def _lenient_yaml_load(path):
    """YAML tolerating `key:value` without the space after the colon."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"^(\s*[A-Za-z_][A-Za-z0-9_]*):(?=\S)", r"\1: ", text, flags=re.MULTILINE)
    return yaml.safe_load(text)


def _load_any(path):
    """A document by extension: .toml by tomllib, anything else as YAML."""
    if str(path).endswith(".toml"):
        import tomllib

        with open(path, "rb") as f:
            return tomllib.load(f)
    return _lenient_yaml_load(path)


def _toml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    return '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"'


def _toml_emit(d: dict, prefix="") -> List[str]:
    """Lines of a table: its scalars and plain arrays, then each sub-table
    under its dotted name, then each array of tables (None is left out)."""
    lines = []
    scalars = {k: v for k, v in d.items() if not isinstance(v, (dict, list)) and v is not None}
    arrays = {k: v for k, v in d.items()
              if isinstance(v, list) and not all(isinstance(e, dict) for e in v)}
    tables = {k: v for k, v in d.items() if isinstance(v, dict)}
    table_arrays = {k: v for k, v in d.items()
                    if isinstance(v, list) and v and all(isinstance(e, dict) for e in v)}
    for k, v in scalars.items():
        lines.append(f"{k} = {_toml_scalar(v)}")
    for k, v in arrays.items():
        lines.append(f"{k} = [" + ", ".join(_toml_scalar(e) for e in v) + "]")
    for k, v in tables.items():
        name = f"{prefix}{k}"
        lines.append(f"\n[{name}]")
        lines.extend(_toml_emit(v, name + "."))
    for k, v in table_arrays.items():
        name = f"{prefix}{k}"
        for entry in v:
            lines.append(f"\n[[{name}]]")
            lines.extend(_toml_emit(entry, name + "."))
    return lines


def toml_dumps(d: dict) -> str:
    """A document as TOML text (the reference's emitter, config.py:292-328)."""
    return "\n".join(_toml_emit(d)) + "\n"


def _save_any(doc, path) -> str:
    """Write a document by extension: .toml by `toml_dumps`, else YAML."""
    with open(path, "w") as f:
        if str(path).endswith(".toml"):
            f.write(toml_dumps(doc))
        else:
            yaml.safe_dump(doc, f, sort_keys=False)
    return str(path)


def integrator_options_to_dict(opts) -> dict:
    return {
        "init_step": f"{opts.init_step_s} s",
        "min_step": f"{opts.min_step_s} s",
        "max_step": f"{opts.max_step_s} s",
        "tolerance": opts.tolerance,
        "attempts": opts.attempts,
        "fixed_step": opts.fixed_step,
        "error_ctrl": getattr(opts.error_ctrl, "__name__", "rss_cartesian_step"),
    }


# error controls by function name or by the reference's enum spelling
_ERROR_CTRL_NAMES = {
    "rss_cartesian_step": "RSSCartesianStep",
    "rss_cartesian_state": "RSSCartesianState",
    "rss_step": "RSSStep",
    "rss_state": "RSSState",
    "largest_error": "LargestError",
    "largest_state": "LargestState",
    "largest_step": "LargestStep",
}


def integrator_options_from_dict(d: dict):
    from ..propagators import IntegratorOptions
    from ..propagators.error_ctrl import ErrorControl

    name = str(d.get("error_ctrl", "RSSCartesianStep"))
    name = _ERROR_CTRL_NAMES.get(name, name)
    return IntegratorOptions(
        init_step_s=parse_duration_s(d.get("init_step", 60.0)),
        min_step_s=parse_duration_s(d.get("min_step", 1e-3)),
        max_step_s=parse_duration_s(d.get("max_step", 2700.0)),
        tolerance=float(d.get("tolerance", 1e-12)),
        attempts=int(d.get("attempts", 50)),
        fixed_step=bool(d.get("fixed_step", False)),
        error_ctrl=getattr(ErrorControl, name),
    )


def load_integrator_options(path):
    """IntegratorOptions from YAML or TOML (the reference's options.rs:188-260)."""
    return integrator_options_from_dict(_load_any(path))


def save_integrator_options(opts, path) -> str:
    return _save_any(integrator_options_to_dict(opts), path)
