"""YAML configuration of ground stations and tracking schedules.

Port of the parts of nyx_tpu/io/config.py that station and tracking files
need (:33-175, 252-290, 330-349): durations ("1 min", "24 h"), frames by
name or NAIF ids, noise models, `GroundStation` documents (one, a list, or
a named map) and `TrkConfig` documents (one, or a named map), with the
reference's field names. YAML and TOML are read; YAML is written. The
spacecraft and integrator-options documents and the TOML writer are not
ported yet.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import yaml

from ..constants import NAIF
from ..cosmic.frames import Frame, Frames
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
    """YAML: one station as a document, several as a list."""
    doc = [ground_station_to_dict(g) for g in stations]
    return _save_any(doc if len(doc) > 1 else doc[0], path)


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


def _save_any(doc, path) -> str:
    if str(path).endswith(".toml"):
        raise ConfigError("writing TOML is not ported; save as YAML")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
    return str(path)
