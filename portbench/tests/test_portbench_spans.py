"""The split of the card's idle time by the program's spans
(`pbench/spans.py`) and the three metrics that read it: hand-computed
shares on synthetic spans and device intervals, shares that add up to the
idle share of `mc.run`, and no reading without exactly one `mc.run`."""

from collections import namedtuple
from types import SimpleNamespace

import pytest

from pbench import spans, spec

S = namedtuple("S", "name start_ns end_ns id parent")
METRICS = {"mc_idle_host_pct": "mc", "integ_idle_host_pct": "integ", "eom_idle_host_pct": "eom"}


def tree():
    """mc.run over [0, 100] ns and its tree (ids in order of start)."""
    return [
        S("mc.run", 0, 100, 1, None),
        S("mc.draw", 0, 10, 2, 1),
        S("integ.propagate", 12, 90, 3, 1),
        S("integ.check", 12, 14, 4, 3),
        S("integ.step", 14, 50, 5, 3),
        S("eom.call", 15, 45, 6, 5),
        S("eom.gravity", 20, 30, 7, 6),
        S("user.region", 41, 44, 8, 6),  # no layer's prefix: its parent's layer
        S("integ.step", 50, 88, 9, 3),
        S("eom.call", 51, 80, 10, 9),
        S("mc.gather", 90, 99, 11, 1),
    ]


# device operations: two overlapping on [13, 40], and some outside mc.run
EVENTS = [("copy", 5, 8), ("a", 13, 30), ("b", 25, 40), ("c", 46, 85), ("d", 95, 97),
          ("before", -20, -10), ("after", 101, 130)]
# idle ns by span, each idle instant given to the innermost open span
BY_NAME = {"mc.run": 3, "mc.draw": 7, "integ.propagate": 2, "integ.check": 1,
           "integ.step": 1 + 3, "eom.call": 2 + 0, "eom.gravity": 0, "user.region": 3,
           "mc.gather": 7}


def test_hand_computed_split():
    by_name, by_layer, run_ns = spans.idle_split(tree(), EVENTS)
    assert by_name == BY_NAME
    assert by_layer == {"mc": 17, "integ": 7, "eom": 5}
    busy_in_run = 3 + 27 + 39 + 2
    assert run_ns == 100 and sum(by_layer.values()) == run_ns - busy_in_run


def _run(events):
    return SimpleNamespace(window=SimpleNamespace(trace=SimpleNamespace(events=events)))


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_read_the_split(monkeypatch, name):
    monkeypatch.setattr(spans, "program_spans", tree)
    value = spec.reader(name)(_run(EVENTS))
    assert value == pytest.approx({"mc": 17.0, "integ": 7.0, "eom": 5.0}[METRICS[name]])


def test_metrics_sum_to_the_idle_share(monkeypatch):
    """On a real 8-lane run of the program (spans recorded by
    `record_spans()`), with device intervals dropped over it, the three
    shares add up to the card's idle share of mc.run."""
    import torch

    from nyx_tpu_torch import tracing
    from pbench import scene

    cell = spec.resolve("leo21.mc_2m_1h")
    s = scene.build(cell.config, spec.ROOT, 5)
    tracing.clear_spans()
    with tracing.record_spans():
        s.mc.run_until_epoch(s.prop, s.almanac, s.epoch + 300.0, 8, device=torch.device("cpu"))
    recorded = tracing.spans()
    tracing.clear_spans()
    monkeypatch.setattr(spans, "program_spans", lambda: recorded)
    run = [x for x in recorded if x.name == "mc.run"][0]
    lo, hi = run.start_ns, run.end_ns
    step = (hi - lo) // 50
    events = [("k", t, t + step // 2) for t in range(lo - step, hi + step, step)]
    busy = sum(min(e, hi) - max(s0, lo) for _, s0, e in events if min(e, hi) > max(s0, lo))
    r = _run(events)
    total = sum(spec.reader(name)(r) for name in METRICS)
    assert total == pytest.approx(100.0 * (1 - busy / (hi - lo)), abs=1e-9)
    assert all(spec.reader(name)(r) > 0 for name in METRICS)


@pytest.mark.parametrize("case", ["no mc.run", "two mc.run", "no spans in the program",
                                  "spans dropped", "no trace"])
def test_no_reading(monkeypatch, case):
    from nyx_tpu_torch import tracing

    run = _run(EVENTS)
    if case == "no mc.run":
        monkeypatch.setattr(spans, "program_spans", lambda: tree()[1:])
    elif case == "two mc.run":
        monkeypatch.setattr(spans, "program_spans",
                            lambda: tree() + [S("mc.run", 200, 300, 12, None)])
    elif case == "no spans in the program":
        monkeypatch.delattr(tracing, "spans")
    elif case == "spans dropped":
        monkeypatch.setattr(tracing, "dropped_spans", lambda: 1)
    else:
        run.window.trace = None
    for name in METRICS:
        assert spec.reader(name)(run) is None
