"""Set-up and the measured window of one cell, driven by its traffic file.

A traffic file gives the lanes of one ensemble, the arc, the mode
(`adaptive`: `MonteCarlo.run_until_epoch`; `encke`:
`MonteCarlo.run_until_epoch_encke` with its `encke` options) and the
warm-up arc. Set-up runs one ensemble of full width over the warm-up arc
(which in the Encke mode also builds the nominal's reference for the arc).
The window then runs whole ensembles back to back, ensemble k drawing its
B lanes from the stream of its own seed (`ensemble_seed`), so that every
ensemble costs the same whichever its place, and closes at the first
ensemble that ends past the run's seconds. Of each ensemble it keeps its
counts and a sample of its lanes drawn from the seed; its lanes that
reached the arc's end with finite states are counted once the window has
closed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

DONE = 1  # a lane's status once it has reached the arc's end


@dataclass
class Ensemble:
    k: int
    wall_s: float
    iterations: int
    n_ok: int
    n_runs: int
    lanes: np.ndarray  # sampled lane indices
    y_initial: np.ndarray  # [len(lanes), 9]
    y_final: np.ndarray
    profiled: bool = False


@dataclass
class Window:
    seconds: float = 0.0
    ensembles: list = field(default_factory=list)
    trace: object = None  # DeviceTrace of the profiled ensemble
    pines_launches: int = 0  # kernel launches in the profiled ensemble


def ensemble_seed(seed: int, k: int) -> int:
    """The Monte Carlo seed of ensemble k of a run seeded `seed`."""
    return int(np.random.SeedSequence([seed, k]).generate_state(1, np.uint64)[0] >> 1)


def sample_lanes(seed: int, k: int, lanes: int, count: int) -> np.ndarray:
    """`count` distinct lanes of ensemble k, drawn from the seed."""
    rng = np.random.default_rng([seed, k])
    return np.sort(rng.choice(lanes, size=min(count, lanes), replace=False))


class Runner:
    """Runs ensembles of one traffic mix through the program's entry."""

    def __init__(self, scene, traffic: dict, device):
        self.s, self.traffic, self.device = scene, traffic, device
        self.lanes = int(traffic["lanes"])
        if traffic["mode"] not in ("adaptive", "encke"):
            raise ValueError(f"unknown traffic mode {traffic['mode']!r}")

    def ensemble(self, arc_s: float, seed: int):
        """One ensemble over `arc_s` from the Monte Carlo seed `seed` (the
        `MonteCarlo`'s public `seed`, set in place so that the Encke mode's
        cached reference is kept)."""
        s, t = self.s, self.traffic
        s.mc.seed = seed
        end = s.epoch + arc_s
        if t["mode"] == "encke":
            e = t["encke"]
            return s.mc.run_until_epoch_encke(s.prop, s.almanac, end, self.lanes,
                                              step_mode=e["step_mode"], integ=e["integ"],
                                              dt_s=e.get("dt_s"), device=self.device)
        return s.mc.run_until_epoch(s.prop, s.almanac, end, self.lanes, device=self.device)

    def warm_up(self, seed: int):
        self.ensemble(float(self.traffic["warmup_s"]), ensemble_seed(seed, 0))

    def window(self, seconds: float, seed: int, trace: bool, sync, launches=None) -> Window:
        """Ensembles back to back until one ends past `seconds`; with
        `trace`, ensemble 1 is profiled (and the window runs two at least).
        `sync()` waits for the card; `launches()` reads the kernel counter."""
        from .trace import DeviceTrace

        arc, B = float(self.traffic["arc_s"]), self.lanes
        per = int(self.traffic["sample_lanes_per_ensemble"])
        w = Window()
        outcomes = []  # each ensemble's status and finals, counted once the window has closed
        t0 = time.perf_counter()
        k = 0
        while True:
            profiled = trace and k == 1
            n0 = launches() if (profiled and launches) else 0
            te = time.perf_counter()
            if profiled:
                w.trace = DeviceTrace()
                with w.trace.capture():
                    res = self.ensemble(arc, ensemble_seed(seed, k))
            else:
                res = self.ensemble(arc, ensemble_seed(seed, k))
            sync()
            t1 = time.perf_counter()
            if profiled and launches:
                w.pines_launches = launches() - n0
            idx = sample_lanes(seed, k, B, per)
            w.ensembles.append(Ensemble(
                k=k, wall_s=t1 - te, iterations=int(res.iterations), n_ok=0,
                n_runs=int(res.n_runs), lanes=idx, y_initial=np.array(res.y_initial[idx]),
                y_final=np.array(res.y_final[idx]), profiled=profiled))
            outcomes.append((res.status, res.y_final))
            del res
            k += 1
            if t1 - t0 >= seconds and (not trace or k >= 2):
                w.seconds = t1 - t0
                for e, (status, y_final) in zip(w.ensembles, outcomes):
                    e.n_ok = int(np.count_nonzero((status == DONE) & np.isfinite(y_final).all(1)))
                return w
