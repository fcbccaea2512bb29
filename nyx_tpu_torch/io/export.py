"""Export: trajectories to parquet and CCSDS OEM.

Torch port of nyx_tpu/io/export.py:22-156 (the reference's ExportCfg-driven
exports, io/mod.rs:53-120 and md/trajectory/sc_traj.rs:183-212). The
parquet columns and their values are the reference's; the watermark and
the OEM's ORIGINATOR name the port. Parameters are evaluated by the port's
`param.value` on the host. pyarrow is imported where a file is written or
read, not with the module.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..time import Epoch

WATERMARK = {"Generator": "nyx-tpu-torch"}

DEFAULT_FIELDS = (
    "x", "y", "z", "vx", "vy", "vz", "sma", "ecc", "inc", "raan", "aop", "ta",
)


@dataclass
class ExportCfg:
    """Field selection, epoch bounds and resampling step for exports."""

    fields: Sequence[str] = DEFAULT_FIELDS
    step: Optional[float] = None  # seconds; None = raw integrator steps
    start_epoch: Optional[Epoch] = None
    end_epoch: Optional[Epoch] = None
    metadata: dict = field(default_factory=dict)
    #: append a UTC timestamp to the filename
    timestamp: bool = False

    @classmethod
    def default(cls) -> "ExportCfg":
        return cls()

    def actual_path(self, path) -> str:
        if not self.timestamp:
            return str(path)
        p = Path(str(path))
        stamp = _dt.datetime.now(_dt.timezone.utc).strftime("%Y-%m-%dT%H-%M-%S")
        return str(p.with_name(f"{p.stem}-{stamp}{p.suffix}"))


def traj_table(traj, cfg: ExportCfg):
    """The pyarrow table `traj_to_parquet` writes: TAI and UTC epochs, then
    one column per field of `cfg`."""
    import pyarrow as pa

    t = traj if cfg.step is None else traj.resample(cfg.step)
    ts, ys = t.ts, t.ys
    lo = (cfg.start_epoch - t.epoch0).to_seconds() if cfg.start_epoch else -np.inf
    hi = (cfg.end_epoch - t.epoch0).to_seconds() if cfg.end_epoch else np.inf
    mask = (ts >= lo) & (ts <= hi)
    ts, ys = ts[mask], ys[mask]
    cols = {
        "epoch_tai_s": ts + t.epoch0.to_tai_seconds(),
        "epoch_utc": [(t.epoch0 + float(dt)).isoformat("UTC") for dt in ts],
    }
    for f in cfg.fields:
        cols[f] = t.values_of(f, ys)
    meta = {**WATERMARK, **{str(k): str(v) for k, v in cfg.metadata.items()}}
    return pa.table(cols).replace_schema_metadata(meta)


def traj_to_parquet(traj, path, cfg: Optional[ExportCfg] = None) -> str:
    import pyarrow.parquet as pq

    cfg = cfg or ExportCfg()
    path = cfg.actual_path(path)
    pq.write_table(traj_table(traj, cfg), path, compression="zstd")
    return str(path)


def _oem_epoch(epoch: Epoch) -> str:
    return epoch.isoformat("UTC").rsplit(" ", 1)[0]


def traj_to_oem(traj, path, cfg: Optional[ExportCfg] = None) -> str:
    """Write a CCSDS OEM 2.0 ASCII file: one line per node, the epoch in
    UTC and the position and velocity at `.9e`."""
    cfg = cfg or ExportCfg()
    t = traj if cfg.step is None else traj.resample(cfg.step)
    lines = [
        "CCSDS_OEM_VERS = 2.0",
        f"CREATION_DATE = {_dt.datetime.now(_dt.timezone.utc).strftime('%Y-%m-%dT%H:%M:%S')}",
        "ORIGINATOR = nyx-tpu-torch",
        "",
        "META_START",
        "OBJECT_NAME = SPACECRAFT",
        "OBJECT_ID = SPACECRAFT",
        f"CENTER_NAME = {t.template.frame}",
        "REF_FRAME = EME2000",
        "TIME_SYSTEM = UTC",
        f"START_TIME = {_oem_epoch(t.start_epoch)}",
        f"STOP_TIME = {_oem_epoch(t.end_epoch)}",
        "META_STOP",
        "",
    ]
    for dt, y in zip(t.ts, t.ys):
        lines.append(f"{_oem_epoch(t.epoch0 + float(dt))} " + " ".join(f"{v:.9e}" for v in y[0:6]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def read_oem(path, template):
    """Read a CCSDS OEM file back into a Trajectory; Cr, Cd and the
    propellant mass come from `template`."""
    from ..md.trajectory import Trajectory

    epochs, states = [], []
    with open(path) as f:
        in_meta = False
        for line in f:
            line = line.strip()
            if line == "META_START":
                in_meta = True
                continue
            if line == "META_STOP":
                in_meta = False
                continue
            if in_meta or not line or "=" in line or line.startswith("COMMENT"):
                continue
            toks = line.split()
            if len(toks) < 7:
                continue
            epochs.append(Epoch.from_str(toks[0] + " UTC"))
            states.append([float(v) for v in toks[1:7]])
    epoch0 = epochs[0]
    ts = np.array([(e - epoch0).to_seconds() for e in epochs])
    ys = np.zeros((len(states), 9))
    ys[:, 0:6] = np.asarray(states)
    ys[:, 6] = template.cr
    ys[:, 7] = template.cd
    ys[:, 8] = template.prop_mass_kg
    return Trajectory.from_capture(epoch0, ts, ys, template)
