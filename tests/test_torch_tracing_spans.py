"""Spans of nyx_tpu_torch (`tracing.annotate`): the tree a Monte Carlo run
records under the profiler or `record_spans()`, nothing recorded and no
clock read otherwise, the store's cap, and the spans' clock against the
profiler's events (on the CPU here; the card's kernels in the `cuda` test,
run as `python3 -m pytest --noconftest -q -m cuda
tests/test_torch_tracing_spans.py` on a card)."""

import threading
import time
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from nyx_tpu_torch import Epoch, Frames, Orbit, Spacecraft, Thruster, tracing
from nyx_tpu_torch.dynamics import (Drag, Harmonics, OrbitalDynamics, SolarPressure,
                                    SpacecraftDynamics)
from nyx_tpu_torch.ephem.almanac import Almanac
from nyx_tpu_torch.io.gravity import GravityFieldData
from nyx_tpu_torch.mc import MonteCarlo, MvnSpacecraft, StateDispersion
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

JGM3 = Path(__file__).resolve().parents[1] / "data" / "JGM3.cof.gz"
EPOCH = Epoch.from_gregorian_utc(2021, 3, 4, 0, 0, 0)
RK89_STAGES = 16


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear_spans()
    yield
    tracing.clear_spans()


def leo_mc(pert_precision="f64"):
    """Config 2's LEO at 8x8 (split), SRP and drag, RK89 at 1e-9."""
    orbit = Orbit.keplerian(7136.6, 0.0002, 51.6, 30.0, 65.0, 80.0, EPOCH, Frames.EME2000)
    sc = Spacecraft.new(orbit, 100.0, 0.0, 2.0, 2.0, 1.8, 2.2)
    stor = GravityFieldData.from_cof(JGM3, 8, 8, True, Frames.IAU_EARTH)
    field = Harmonics.from_stor(stor, precision="split")
    dyn = SpacecraftDynamics(OrbitalDynamics.from_model(field, Frames.EME2000),
                             (SolarPressure.default(), Drag.earth_exp()),
                             pert_precision=pert_precision)
    prop = Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9))
    mc = MonteCarlo(MvnSpacecraft(sc, [StateDispersion("sma", 0.5)]), seed=2**33 + 7)
    return mc, prop


def test_monte_carlo_span_tree(monkeypatch):
    """Under a CPU profile an 8-lane run records mc.run, then mc.draw,
    mc.context, integ.propagate (integ.check and integ.step, each step 16
    eom.call with eom.gravity, eom.srp and eom.drag inside), mc.gather;
    every span shares mc.run's root, lies inside its parent, and none
    synchronizes a card."""
    mc, prop = leo_mc()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("a span synchronized"))
    with profile(activities=[ProfilerActivity.CPU]):
        res = mc.run_until_epoch(prop, Almanac(), EPOCH + 600.0, 8, device="cpu")
    spans = tracing.spans()
    by_id = {s.id: s for s in spans}
    run = [s for s in spans if s.name == "mc.run"]
    assert len(run) == 1 and run[0].parent is None
    run = run[0]
    assert run.attrs == {"lanes": 8, "seed": mc.seed, "skip": 0}

    def kids(span):
        return [s.name for s in spans if s.parent == span.id]

    assert kids(run) == ["mc.draw", "mc.context", "integ.propagate", "mc.gather"]
    assert by_id[run.id + 1].attrs == {"rows": 8}  # mc.draw
    prop_span = next(s for s in spans if s.name == "integ.propagate")
    assert prop_span.attrs == {"lanes": 8, "iterations": res.iterations}
    assert set(kids(prop_span)) == {"integ.check", "integ.step"}
    counts = Counter(s.name for s in spans)
    assert counts["integ.step"] == res.iterations > 0
    assert counts["eom.call"] == RK89_STAGES * counts["integ.step"]
    for s in spans:
        if s.name == "integ.step":
            assert set(kids(s)) == {"eom.call"}
        if s.name == "eom.call":
            assert kids(s) == ["eom.gravity", "eom.srp", "eom.drag"]
        assert s.root == run.id and s.thread == threading.current_thread().name
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    assert tracing.dropped_spans() == 0


def test_nothing_records_when_off(monkeypatch):
    """Without a profiler or record_spans(): no span, no clock read, and
    every call returns the same shared no-op."""
    mc, prop = leo_mc()

    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(tracing.time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(tracing.time, "time_ns", no_clock)
    monkeypatch.setattr(tracing, "_LiveSpan", no_clock)
    res = mc.run_until_epoch(prop, Almanac(), EPOCH + 300.0, 8, device="cpu")
    assert res.n_ok == 8
    assert tracing.spans() == [] and tracing.dropped_spans() == 0
    assert tracing.annotate("a") is tracing.annotate("b", lanes=3)
    with tracing.annotate("a") as span:
        span.set(iterations=1)
    assert tracing.spans() == []


def test_record_spans_threads_and_cap(monkeypatch):
    """record_spans() records without a profiler; another thread's spans
    have a root of their own; past the cap spans are counted, not kept;
    clear_spans() empties both."""
    with tracing.record_spans():
        with tracing.annotate("outer", k=1) as outer:
            with tracing.annotate("inner"):
                pass
            t = threading.Thread(target=lambda: tracing.annotate("other").__enter__().__exit__(
                None, None, None), name="worker")
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            outer.set(k=2)
    spans = {s.name: s for s in tracing.spans()}
    assert spans["outer"].attrs == {"k": 2} and spans["outer"].parent is None
    assert spans["inner"].parent == spans["outer"].id == spans["inner"].root
    assert spans["other"].parent is None and spans["other"].root == spans["other"].id
    assert spans["other"].thread == "worker"
    with tracing.annotate("after"):
        pass
    assert "after" not in {s.name for s in tracing.spans()}

    monkeypatch.setattr(tracing._REC, "cap", 4)
    with tracing.record_spans():
        for _ in range(3):
            with tracing.annotate("x"):
                pass
    assert len(tracing.spans()) == 4 and tracing.dropped_spans() == 2
    tracing.clear_spans()
    assert tracing.spans() == [] and tracing.dropped_spans() == 0


def test_kept_spans_leave_the_collector_alone():
    """Kept spans without attributes are records the garbage collector
    stops tracking, so a long profile's store adds nothing to its passes
    (a tracked store cost ~12 us a span on an H100 machine's host under a
    CUDA profile)."""
    import gc

    gc.collect()
    before = len(gc.get_objects())
    with tracing.record_spans():
        for _ in range(5000):
            with tracing.annotate("eom.call"):
                pass
    gc.collect()
    assert len(tracing.spans()) == 5000
    assert len(gc.get_objects()) - before < 500


def test_span_clock_is_the_profilers():
    """A span's start lies within 1 ms of the profiler's start of a
    record_function opened first thing inside it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        with tracing.annotate("outer"):
            with record_function("probe"):
                torch.ones(4).sum()
    span = next(s for s in tracing.spans() if s.name == "outer")
    probe = next(e for e in prof.profiler.kineto_results.events() if e.name() == "probe")
    assert abs(probe.start_ns() - span.start_ns) < 1_000_000, (probe.start_ns(), span.start_ns)


class _Coast:
    """A guidance law that never thrusts."""

    def required_bodies(self):
        return ()

    def direction_and_throttle(self, ctx, t_tdb, y9, mode):
        return torch.zeros_like(y9[..., 0:3]), torch.zeros_like(y9[..., 0])


def test_split_eom_and_guidance_spans():
    """With f32 perturbations the EOM splits two-body from the field; a
    guidance law gets its own span."""
    _, prop = leo_mc("f32")
    dyn = prop.dynamics
    ctx = dyn.build_context(EPOCH, 60.0, Almanac(), device="cpu")
    y = torch.tensor([[7136.6, 0.0, 0.0, 0.0, 7.47, 0.0, 1.8, 2.2, 0.0]], dtype=torch.float64)
    p = dict(dry_mass_kg=100.0, srp_area_m2=2.0, drag_area_m2=2.0)
    guided = SpacecraftDynamics(dyn.orbital_dyn, dyn.force_models, _Coast())
    thruster = Thruster(thrust_N=1.0, isp_s=300.0)
    with tracing.record_spans():
        dyn.make_eom()(torch.zeros(1, dtype=torch.float64), y, ctx, p)
        guided.make_eom(thruster=thruster)(torch.zeros(1, dtype=torch.float64),
                                           torch.cat([y, torch.zeros(1, 1)], 1), ctx, p)
    spans = tracing.spans()
    calls = [s for s in spans if s.name == "eom.call"]
    assert len(calls) == 2
    kids = [[s.name for s in spans if s.parent == c.id] for c in calls]
    assert kids[0] == ["eom.two_body", "eom.gravity", "eom.srp", "eom.drag"]
    assert kids[1] == ["eom.gravity", "eom.srp", "eom.drag", "eom.guidance"]


def test_profile_trace_enters_ranges(tmp_path):
    """Inside profile_trace with host tracing a span is recorded and shows
    on the Chrome timeline; the ranges stop with it."""
    import json

    with tracing.profile_trace(tmp_path, cuda=False) as session:
        with tracing.annotate("mc.run"):
            torch.ones(8).sum()
    names = {e.get("name") for e in json.loads(session.trace_path.read_text())["traceEvents"]}
    assert "mc.run" in names
    assert [s.name for s in tracing.spans()] == ["mc.run"]
    assert tracing._REC.ranges == 0 and tracing._REC.depth == 0


@pytest.mark.cuda
def test_span_encloses_its_kernel_on_card():
    """On the card a span around a 64M-element add_ and a synchronize
    encloses that kernel's interval in a CUDA-only profile (the device
    trace's clock), within 50 us at each end. Two-sided: the host polls
    the stream inside the span, and the kernel's end in the trace lies
    between the start of the last poll that found it running and the
    return of the first that found it done, within 50 us at each end.
    The profile's first launch is a one-element add_ outside the span:
    CUPTI requests its activity buffer inside that launch, which holds
    the host ~1.5-2 ms, long after the kernel it launches has ended."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel's times come from the card's trace")
    x = torch.ones(64 << 20, device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    slack = 50_000
    for _ in range(3):
        tracing.clear_spans()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            x[:1].add_(1.0)
            torch.cuda.synchronize()
            with tracing.annotate("probe"):
                x.add_(1.0)
                running = None  # the start of the last poll that found the kernel running
                while True:
                    poll = time.time_ns()
                    if stream.query():
                        done = time.time_ns()
                        break
                    running = poll
                torch.cuda.synchronize()
        span = next(s for s in tracing.spans() if s.name == "probe")
        cuda = torch.autograd.DeviceType.CUDA
        kernels = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and "elementwise" in e.name()]
        assert len(kernels) == 2, [e.name() for e in kernels]
        kernel = max(kernels, key=lambda e: e.duration_ns())  # the probe's, not the warm-up's
        k_start = kernel.start_ns()
        k_end = k_start + kernel.duration_ns()
        print(f"\nkernel from {k_start - span.start_ns} ns after the span opens to "
              f"{span.end_ns - k_end} ns before it closes; its end "
              f"{'-' if running is None else k_end - running} ns after the last running poll, "
              f"{done - k_end} ns before the first done poll's return")
        assert running is not None, "the first poll found the kernel done: no lower bound on its end"
        assert span.start_ns - slack <= k_start and k_end <= span.end_ns + slack
        assert running - slack <= k_end <= done + slack
