"""The rest of a run on the CPU, at a tiny width and a short arc: each
cell's window through the program and the plain reference agree; the
float32 control and a timed path broken underneath come out not correct;
and no module loaded is JAX's or the JAX package's."""

import importlib.util
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pbench import check, spec

BENCH = spec.BENCH_DIR
SEED = 2**31 + 977


def _run_module():
    s = importlib.util.spec_from_file_location("portbench_run", BENCH / "run.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def tiny(name, lanes=8, arc_s=600.0):
    """The cell with its traffic cut to `lanes` lanes over `arc_s`."""
    cell = spec.resolve(name)
    t = cell.traffic
    t.update(lanes=lanes, sample_lanes_per_ensemble=4)
    if t["mode"] == "encke":
        t.update(arc_s=max(arc_s, 1800.0), warmup_s=max(arc_s, 1800.0))
    else:
        t.update(arc_s=arc_s, warmup_s=60.0)
    return cell


def execute(cell, seconds=1.0):
    return _run_module().execute(cell, SEED, seconds, False, torch.device("cpu"),
                                 time.perf_counter())


@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_cell_agrees_with_reference(name):
    r = execute(tiny(name))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 8 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in spec.resolve(name).end_to_end}
    assert list(r)[-1] == "checks"


def test_encke_traffic_agrees_with_reference():
    """The Encke mix, kept for a later cell (`PERF.md`), through the runner
    and the reference at a tiny width over half an hour."""
    import json

    from pbench import reference
    from pbench.window import Runner

    cell = spec.resolve("leo21.mc_2m_1h")
    traffic = json.loads((BENCH / "traffic" / "encke_1m_2h.json").read_text())
    traffic.update(lanes=8, arc_s=1800.0, warmup_s=1800.0, sample_lanes_per_ensemble=4)
    from pbench import scene

    runner = Runner(scene.build(cell.config, spec.ROOT, SEED), traffic, torch.device("cpu"))
    runner.warm_up(SEED)
    win = runner.window(0.0, SEED, False, sync=lambda: None)
    numbers, _ = check.program_numbers(cell.config, spec.ROOT, traffic, win, SEED)
    assert numbers["failed_lanes"] == 0 and numbers["draw_pos_km"] < 1e-6
    assert numbers["final_pos_km"] < 1e-4, numbers


def test_control_fails():
    """The reference at float32 in the program's place fails the limits."""
    cell = tiny("leo21.mc_2m_1h")
    from pbench import reference
    from pbench.window import ensemble_seed, sample_lanes

    picks = [(k, int(i)) for k in range(2) for i in sample_lanes(SEED, k, 8, 4)]
    y0 = reference.draws(cell.config, {k: ensemble_seed(SEED, k) for k in range(2)}, 8, picks)
    yf = reference.propagate(cell.config, spec.ROOT, y0, cell.traffic["arc_s"])
    numbers = check.control_numbers(cell.config, spec.ROOT, cell.traffic, y0, yf)
    ok, shown = check.judge(numbers, check.load_limits(cell.limits_path))
    assert not ok, shown
    assert numbers["final_pos_km"] > 10 * shown["final_pos_km"][1]


def _break(monkeypatch, fault):
    from nyx_tpu_torch.mc import montecarlo
    from nyx_tpu_torch.propagators import integrator

    if fault == "step returns its state":
        def stages(eom, a, b, b_star, c, t, y, h):
            return torch.zeros_like(y), torch.zeros_like(y)
        monkeypatch.setattr(integrator, "_rk_stages", stages)
    elif fault == "half of the lanes left out":
        real = integrator.propagate

        def half(eom, y0, *a, **k):
            n = y0.shape[0] // 2
            res = real(eom, y0[:n], *a, **k)
            cat = lambda x, y: torch.cat([x, y])  # noqa: E731
            return res._replace(y=cat(res.y, y0[n:]), status=cat(res.status, res.status[: y0.shape[0] - n]),
                                n_accepted=cat(res.n_accepted, res.n_accepted[: y0.shape[0] - n]),
                                n_rejected=cat(res.n_rejected, res.n_rejected[: y0.shape[0] - n]))
        monkeypatch.setattr(montecarlo.integrator, "propagate", half)
    elif fault == "answer altered":
        real = integrator.propagate

        def shifted(*a, **k):
            res = real(*a, **k)
            y = res.y.clone()
            y[:, 0] += 1e-2  # ten metres
            return res._replace(y=y)
        monkeypatch.setattr(montecarlo.integrator, "propagate", shifted)
    elif fault == "draws ignore the seed":
        real = montecarlo.MonteCarlo.generate_states

        def seed_zero(self, n, skip=0, **k):
            self.seed = 0
            return real(self, n, skip, **k)
        monkeypatch.setattr(montecarlo.MonteCarlo, "generate_states", seed_zero)


@pytest.mark.parametrize("fault", ["step returns its state", "half of the lanes left out",
                                   "answer altered", "draws ignore the seed"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    _break(monkeypatch, fault)
    r = execute(tiny("leo21.mc_2m_1h", arc_s=300.0))
    assert not r["correct"], (fault, r["checks"])


def test_no_jax_module_loaded():
    """A CPU run in a fresh process loads no module whose top-level name is
    jax, jaxlib, flax or nyx_tpu (compared whole)."""
    code = f"""
import sys, time, torch
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
import importlib.util
s = importlib.util.spec_from_file_location("portbench_run", {str(BENCH / 'run.py')!r})
run = importlib.util.module_from_spec(s); s.loader.exec_module(run)
from pbench import spec
cell = spec.resolve("leo21.mc_2m_1h")
cell.traffic.update(lanes=4, arc_s=120.0, warmup_s=60.0, sample_lanes_per_ensemble=2)
run.execute(cell, 5, 0.1, False, torch.device("cpu"), time.perf_counter())
print("FOUND", run.loaded_forbidden(), sorted(m for m in sys.modules if m.split('.')[0] == 'nyx_tpu_torch')[:1])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("FOUND")][-1]
    assert line == "FOUND [] ['nyx_tpu_torch']", line


def test_forbidden_names_compare_whole(monkeypatch):
    import types

    run = _run_module()
    monkeypatch.setitem(sys.modules, "nyx_tpu_torchx", types.ModuleType("nyx_tpu_torchx"))
    assert "nyx_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in run.loaded_forbidden()


def test_no_card_exits_without_result():
    """Without a card the command exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "leo21.mc_2m_1h",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(BENCH.parent))
    assert out.returncode != 0 and not out.stdout.strip()
