"""Tracking-arc simulation: visibility scheduling + measurement generation.

Torch port of nyx_tpu/od/simulator.py:27-282. Visibility samples the truth
trajectory at each device's cadence (one batched interpolation) and
evaluates the device's elevation over all the samples in one batched call
on the simulator's device; strand extraction, the cadence (continuous, or
intermittent on/off), the strands' alignment, the eager and greedy
hand-off, manual strands and the noise stay on the host. Devices are duck
typed: ground stations (with terrain masks and centre-offset tables) and
interlink transmitters, whose pseudo-elevation carries the occultation
gate. A manual strand is taken whole by the schedule and gated measurement
by measurement. Noise comes from one `numpy.random.default_rng(seed)`
generator, drawn in the reference's order (a device's timestamp noise
before its per-type noises), so the same schedule gives the same noise. A
two-way device's values are the average of its one-way values at t and
t - T_int, with the noise scaled by 1/sqrt(2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..time import Duration, Epoch
from .ground_station import require_same_center
from .msr import Measurement, TrackingDataArc
from .noise import NoiseState


def _secs(x) -> float:
    return x.to_seconds() if isinstance(x, Duration) else float(x)


class Cadence:
    Continuous = "continuous"
    Intermittent = "intermittent"


@dataclass(frozen=True)
class Scheduler:
    """Visibility-strand post-processing: the hand-off between devices
    whose strands overlap, the cadence, the shortest strand kept, and the
    grid strand starts are rounded up to."""

    handoff: str = "eager"  # 'eager' | 'greedy' | 'overlap'
    cadence: str = Cadence.Continuous
    min_samples: int = 10
    sample_alignment_s: Optional[float] = None
    # intermittent cadence: track for on_s, stand down for off_s
    on_s: Optional[float] = None
    off_s: Optional[float] = None

    @classmethod
    def intermittent(cls, on, off, **kw) -> "Scheduler":
        return cls(cadence=Cadence.Intermittent, on_s=_secs(on), off_s=_secs(off), **kw)


@dataclass
class TrkConfig:
    """Per-device tracking configuration; `strands`, if given, are the
    manual (start, end) epochs tracked instead of the visibility strands."""

    sampling_s: float = 60.0
    scheduler: Optional[Scheduler] = None
    strands: Optional[List[Tuple[Epoch, Epoch]]] = None

    @classmethod
    def default(cls) -> "TrkConfig":
        return cls(sampling_s=60.0, scheduler=Scheduler())

    @classmethod
    def from_sample_rate(cls, rate) -> "TrkConfig":
        return cls(sampling_s=_secs(rate), scheduler=Scheduler())


@dataclass
class Strand:
    device: str
    start_idx: int
    end_idx: int  # inclusive sample indices into the sim grid


class TrackingArcSim:
    """Devices + truth trajectory + configs + seed; device geometry runs
    on `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, devices: Sequence, trajectory, configs: Dict[str, TrkConfig],
                 seed: int = 0, *, device="cuda"):
        self.devices = list(devices)
        self.traj = trajectory
        self.configs = dict(configs)
        self.seed = seed
        self.device = device
        self._schedule: Optional[List[Strand]] = None
        self._grid_cache = {}
        require_same_center(self.devices, trajectory.template.frame)
        for d in self.devices:
            if d.name not in self.configs:
                self.configs[d.name] = TrkConfig.default()

    @classmethod
    def with_seed(cls, devices, trajectory, configs, seed, *, device="cuda"):
        return cls(devices, trajectory, configs, seed, device=device)

    def _sample_grid(self, sampling_s: float):
        """(relative seconds [K], states [K, 6]) over the trajectory, cached
        per sampling rate."""
        if sampling_s not in self._grid_cache:
            t0, t1 = float(self.traj.ts[0]), float(self.traj.ts[-1])
            ts = np.arange(t0, t1 + 1e-6, sampling_s)
            ys = self.traj.interpolate_many(ts)[:, :6]
            self._grid_cache[sampling_s] = (ts, ys)
        return self._grid_cache[sampling_s]

    def build_schedule(self, almanac=None) -> List[Strand]:
        """Strands per device (its manual strands, or its visibility
        strands under its cadence, alignment and shortest strand), then the
        scheduler's hand-off. `almanac` is accepted as the reference accepts
        it, and unused: the devices carry what they need."""
        strands: List[Strand] = []
        grids = {}
        t0_tdb = self.traj.epoch0.to_tdb_seconds()
        for dev in self.devices:
            cfg = self.configs[dev.name]
            ts, ys = self._sample_grid(cfg.sampling_s)
            grids[dev.name] = (ts, ys)
            if cfg.strands is not None:
                for s, e in cfg.strands:
                    i0 = int(np.searchsorted(ts, (s - self.traj.epoch0).to_seconds()))
                    i1 = int(np.searchsorted(ts, (e - self.traj.epoch0).to_seconds(), "right")) - 1
                    if i1 >= i0:
                        strands.append(Strand(dev.name, i0, i1))
                continue
            az, el = dev.batch_azel(t0_tdb + ts, ys, device=self.device)
            visible = el >= dev.min_elevation_deg(az)
            sched = cfg.scheduler or Scheduler()
            if sched.cadence == Cadence.Intermittent and sched.on_s:
                period = sched.on_s + (sched.off_s or 0.0)
                visible = visible & ((ts - ts[0]) % period < sched.on_s)
            idx = np.where(visible)[0]
            if len(idx) == 0:
                continue
            # contiguous visible runs -> strands, each start rounded up to
            # the alignment grid
            cuts = np.where(np.diff(idx) > 1)[0] + 1
            for run in np.split(idx, cuts):
                start = int(run[0])
                if sched.sample_alignment_s:
                    align = sched.sample_alignment_s
                    t_aligned = np.ceil((ts[start] - 1e-9) / align) * align
                    while start <= run[-1] and ts[start] < t_aligned - 1e-9:
                        start += 1
                if run[-1] - start + 1 >= sched.min_samples:
                    strands.append(Strand(dev.name, start, int(run[-1])))

        strands.sort(key=lambda s: s.start_idx)
        # eager: a new station takes over as soon as it sees the spacecraft
        # and the previous strand is cut; greedy: the previous strand runs
        # out and the new one starts after it
        sched_by_dev = {d.name: (self.configs[d.name].scheduler or Scheduler())
                        for d in self.devices}
        pruned: List[Strand] = []
        for s in strands:
            if pruned:
                prev = pruned[-1]
                overlap = s.device != prev.device and s.start_idx <= prev.end_idx
                handoff = sched_by_dev[prev.device].handoff
                if overlap and handoff == "eager":
                    prev.end_idx = max(prev.start_idx, s.start_idx - 1)
                elif overlap and handoff == "greedy":
                    s = Strand(s.device, prev.end_idx + 1, s.end_idx)
                    if s.start_idx > s.end_idx:
                        continue
            pruned.append(s)
        self._schedule = pruned
        self._grids = grids
        return pruned

    def generate_measurements(self, almanac=None) -> TrackingDataArc:
        """Sample every strand at its device's cadence, with seeded noise
        (`almanac` as in `build_schedule`). A sample below the device's
        elevation or terrain mask (for an interlink, an occulted one) gives
        no measurement."""
        if self._schedule is None:
            self.build_schedule(almanac)
        rng = np.random.default_rng(self.seed)
        dev_map = {d.name: d for d in self.devices}

        def noises(d):
            n = dict(d.stochastic_noises)
            if getattr(d, "timestamp_noise_s", None) is not None:
                n["__timestamp__"] = d.timestamp_noise_s
            return n

        noise_states = {d.name: NoiseState(noises(d), rng) for d in self.devices}
        epoch0 = self.traj.epoch0
        t0_tdb = epoch0.to_tdb_seconds()
        measurements: List[Measurement] = []
        for strand in self._schedule:
            dev = dev_map[strand.device]
            ts, ys = self._grids[strand.device]
            sl = slice(strand.start_idx, strand.end_idx + 1)
            # one batched device call for the whole strand, then host-side
            # noise in deterministic per-epoch order
            vals, els = dev.batch_values(t0_tdb + ts[sl], ys[sl], device=self.device)
            noise_scale, skip_before = 1.0, -np.inf
            if dev.integration_time_s:
                # two-way: the average with the values at t - T_int, the
                # state there clamped to the trajectory's start, whose
                # first T_int seconds give no measurement
                t_int = float(dev.integration_time_s)
                t_first = float(self.traj.ts[0])
                ts_sl = ts[sl]
                ys0 = self.traj.interpolate_many(np.maximum(ts_sl - t_int, t_first))[:, :6]
                vals0, _ = dev.batch_values(t0_tdb + ts_sl - t_int, ys0, device=self.device)
                vals = 0.5 * (vals + vals0)
                noise_scale, skip_before = 1.0 / np.sqrt(2.0), t_first + t_int
            # the azimuths only where a terrain mask reads them
            azs = (dev.batch_azel(t0_tdb + ts[sl], ys[sl], device=self.device)[0]
                   if dev.active_terrain_mask is not None else np.zeros(len(els)))
            min_el = dev.min_elevation_deg(azs)
            ts_noise = getattr(dev, "timestamp_noise_s", None) is not None
            nstate = noise_states[strand.device]
            for k, i in enumerate(range(strand.start_idx, strand.end_idx + 1)):
                if els[k] < min_el[k] or ts[i] < skip_before:
                    continue
                epoch = epoch0 + float(ts[i])
                t_tai = epoch.to_tai_seconds()
                # the timestamp noise moves the tagged epoch, drawn before
                # the per-type noises
                if ts_noise:
                    epoch = epoch + nstate.sample("__timestamp__", t_tai, rng)
                data = {
                    mtype: float(vals[k, j]) + noise_scale * nstate.sample(mtype, t_tai, rng)
                    for j, mtype in enumerate(dev.measurement_types)
                }
                measurements.append(Measurement(dev.name, epoch, data))
        return TrackingDataArc.from_measurements(measurements)
