"""Tracking-arc simulation: visibility scheduling + measurement generation.

Torch port of nyx_tpu/od/simulator.py:31-282 for continuous tracking.
Visibility samples the truth trajectory at each device's cadence and
evaluates the device's elevation over all the samples in one batched call
on the simulator's device; strand extraction, the eager and greedy
hand-off and the noise stay on the host. Noise comes from one
`numpy.random.default_rng(seed)` generator, drawn in the reference's
order, so the same schedule gives the same noise. A two-way device's
values are the average of its one-way values at t and t - T_int, with the
noise scaled by 1/sqrt(2) (the reference's simulator.py:241-258).
Intermittent cadence, strand alignment, manual strands, timestamp noise
and terrain masks are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .ground_station import require_same_center
from .msr import Measurement, TrackingDataArc
from .noise import NoiseState


@dataclass(frozen=True)
class Scheduler:
    """Visibility-strand post-processing: the hand-off between stations
    whose strands overlap, and the shortest strand kept."""

    handoff: str = "eager"  # 'eager' | 'greedy' | 'overlap'
    min_samples: int = 10


@dataclass
class TrkConfig:
    """Per-device tracking configuration."""

    sampling_s: float = 60.0
    scheduler: Optional[Scheduler] = None


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
                self.configs[d.name] = TrkConfig(scheduler=Scheduler())

    @classmethod
    def with_seed(cls, devices, trajectory, configs, seed, *, device="cuda"):
        return cls(devices, trajectory, configs, seed, device=device)

    def _sample_grid(self, sampling_s: float):
        """(relative seconds [K], states [K, 6]) over the trajectory, cached
        per sampling rate."""
        if sampling_s not in self._grid_cache:
            t0, t1 = float(self.traj.ts[0]), float(self.traj.ts[-1])
            ts = np.arange(t0, t1 + 1e-6, sampling_s)
            ys = np.stack([self.traj.interpolate(t)[:6] for t in ts])
            self._grid_cache[sampling_s] = (ts, ys)
        return self._grid_cache[sampling_s]

    def build_schedule(self, almanac=None) -> List[Strand]:
        """Visibility strands per device, then the scheduler's hand-off.
        `almanac` is accepted as the reference accepts it, and unused: the
        stations' geometry needs no ephemeris."""
        strands: List[Strand] = []
        grids = {}
        t0_tdb = self.traj.epoch0.to_tdb_seconds()
        for dev in self.devices:
            cfg = self.configs[dev.name]
            ts, ys = self._sample_grid(cfg.sampling_s)
            grids[dev.name] = (ts, ys)
            _, el = dev.batch_azel(t0_tdb + ts, ys, device=self.device)
            idx = np.where(el >= dev.elevation_mask_deg)[0]
            if len(idx) == 0:
                continue
            min_samples = (cfg.scheduler or Scheduler()).min_samples
            # contiguous visible runs -> strands
            cuts = np.where(np.diff(idx) > 1)[0] + 1
            for run in np.split(idx, cuts):
                if len(run) >= min_samples:
                    strands.append(Strand(dev.name, int(run[0]), int(run[-1])))

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
        (`almanac` as in `build_schedule`)."""
        if self._schedule is None:
            self.build_schedule(almanac)
        rng = np.random.default_rng(self.seed)
        dev_map = {d.name: d for d in self.devices}
        noise_states = {d.name: NoiseState(dict(d.stochastic_noises), rng) for d in self.devices}
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
                ys0 = np.stack([self.traj.interpolate(max(t - t_int, t_first))[:6] for t in ts_sl])
                vals0, _ = dev.batch_values(t0_tdb + ts_sl - t_int, ys0, device=self.device)
                vals = 0.5 * (vals + vals0)
                noise_scale, skip_before = 1.0 / np.sqrt(2.0), t_first + t_int
            nstate = noise_states[strand.device]
            for k, i in enumerate(range(strand.start_idx, strand.end_idx + 1)):
                if els[k] < dev.elevation_mask_deg or ts[i] < skip_before:
                    continue
                epoch = epoch0 + float(ts[i])
                t_tai = epoch.to_tai_seconds()
                data = {
                    mtype: float(vals[k, j]) + noise_scale * nstate.sample(mtype, t_tai, rng)
                    for j, mtype in enumerate(dev.measurement_types)
                }
                measurements.append(Measurement(dev.name, epoch, data))
        return TrackingDataArc.from_measurements(measurements)
