"""The card's idle time in the profiled ensemble, split by what the host
was doing: the program's spans laid over the device trace.

While the profiler runs, the program records spans
(`nyx_tpu_torch.tracing.spans()`) on the clock of the trace's events (Unix
ns): the `--trace 1` ensemble holds one `mc.run` span and its tree
(`mc.draw`, `mc.context`, `integ.propagate`, `integ.check`, `integ.step`,
`eom.call`, `eom.gravity`, `eom.srp`, ...). Every instant of `mc.run`'s
interval at which no device operation ran is given to the innermost span
of that tree open at that instant, so the shares of all spans add up to
the card's idle share of `mc.run`. A span's layer is the prefix of its
name (`mc`, `integ`, `eom`), or its parent's where the prefix is none of
these. A program without spans, a store that dropped some, or a run with
no `mc.run` or more than one, reads None.
"""

from __future__ import annotations

import bisect
from itertools import accumulate

ROOT = "mc.run"
LAYERS = ("mc", "integ", "eom")


def program_spans():
    """The program's recorded spans, or None where it records none."""
    try:
        from nyx_tpu_torch import tracing
    except ImportError:
        return None
    read = getattr(tracing, "spans", None)
    if read is None or getattr(tracing, "dropped_spans", lambda: 0)():
        return None
    return read()


class _Busy:
    """The union of device intervals, and the busy time inside any
    interval of the host's clock."""

    def __init__(self, events):
        merged = []
        for _, s, e in sorted(events, key=lambda ev: ev[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.before = [0] + list(accumulate(e - s for s, e in merged))

    def upto(self, t: int) -> int:
        """Busy ns before `t`."""
        i = bisect.bisect_right(self.starts, t)  # intervals that start at or before t
        if i == 0:
            return 0
        return self.before[i - 1] + min(t, self.ends[i - 1]) - self.starts[i - 1]

    def idle(self, a: int, b: int) -> int:
        return (b - a) - (self.upto(b) - self.upto(a)) if b > a else 0


def idle_split(spans, events):
    """(idle ns by span name, idle ns by layer, `mc.run`'s ns), each idle
    instant of `mc.run`'s interval given to the innermost span open then;
    None unless the spans hold exactly one `mc.run`. `spans` have `name`,
    `start_ns`, `end_ns`, `id` and `parent`; `events` are (name, start_ns,
    end_ns) of device operations."""
    runs = [s for s in spans if s.name == ROOT]
    if len(runs) != 1:
        return None
    run = runs[0]
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    busy = _Busy(events)
    by_name, by_layer = {}, dict.fromkeys(LAYERS, 0)
    todo = [(run, "mc", run.start_ns, run.end_ns)]
    while todo:
        span, up_layer, lo, hi = todo.pop()
        prefix = span.name.split(".", 1)[0]
        layer = prefix if prefix in LAYERS else up_layer
        # the span's own time: its interval (inside its parent's) less its children's
        t, idle = lo, 0
        for c in sorted(children.get(span.id, ()), key=lambda c: c.start_ns):
            c_lo, c_hi = max(c.start_ns, t), min(c.end_ns, hi)
            if c_hi <= c_lo:
                continue
            idle += busy.idle(t, c_lo)
            todo.append((c, layer, c_lo, c_hi))
            t = c_hi
        idle += busy.idle(t, hi)
        by_name[span.name] = by_name.get(span.name, 0) + idle
        by_layer[layer] += idle
    return by_name, by_layer, run.end_ns - run.start_ns


def layer_pct(run, layer: str):
    """The idle share of `mc.run` spent with `layer`'s spans innermost, %,
    in the `--trace 1` run `run`; None where it cannot be read."""
    split = getattr(run, "_idle_split", None)
    if split is None:
        trace = run.window.trace
        spans = program_spans() if trace is not None else None
        split = idle_split(spans, trace.events) if spans is not None else None
        if split is None:
            return None
        run._idle_split = split
    _, by_layer, run_ns = split
    return 100.0 * by_layer[layer] / run_ns if run_ns > 0 else None
