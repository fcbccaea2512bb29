"""The device trace of one ensemble, read in memory.

`torch.profiler` records the card's activity alone (kernels, copies and
sets, with the runtime calls that issued them); nothing is written to disk.
`DeviceTrace.summary` reduces the events to what the per-layer metrics and
the result line read: the device time by operation name, the busy time
(the union of every device interval), the traced window's length, and the
idle gaps, each named by the operation the card waited for.
"""

from __future__ import annotations

import contextlib
import time


def _ns(e, name):
    """An event's start or duration in ns, whichever accessor this torch has."""
    fn = getattr(e, f"{name}_ns", None)
    if fn is not None:
        return int(fn())
    return int(1000 * getattr(e, f"{name}_us")())


class DeviceTrace:
    def __init__(self):
        self.events = []  # (name, start_ns, end_ns) of device activity, by start
        self.window_s = 0.0

    @contextlib.contextmanager
    def capture(self):
        """Profile the card's activity over the block; its window is the
        host's time from the block's start to the card's last operation."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield self
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                start = _ns(e, "start")
                out.append((e.name(), start, start + _ns(e, "duration")))
        out.sort(key=lambda x: x[1])
        self.events = out

    def summary(self, top: int = 10) -> dict:
        """busy_s, window_s, by_name {name: (seconds, count)}, the
        `top` operations by device time and the `top` idle gaps summed by
        the operation that ended them (the first gap, before the card's first
        operation, and the last, after its last, are named apart)."""
        by_name, gaps = {}, {}
        busy_ns, cur_end, first = 0, None, None
        for name, s, e in self.events:
            t, n = by_name.get(name, (0.0, 0))
            by_name[name] = (t + (e - s) / 1e9, n + 1)
            if first is None:
                first = s
            if cur_end is None or s > cur_end:
                if cur_end is not None:
                    key = f"idle before {name[:80]}"
                    gaps[key] = gaps.get(key, 0.0) + (s - cur_end) / 1e9
                busy_ns += e - s
                cur_end = e
            elif e > cur_end:
                busy_ns += e - cur_end
                cur_end = e
        busy_s = busy_ns / 1e9
        if first is not None:
            # the card's span, and the host's time around it in the window
            span_s = (cur_end - first) / 1e9
            outside = max(self.window_s - span_s, 0.0)
            gaps["host before the first and after the last operation"] = outside
        ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
        return dict(
            busy_s=busy_s,
            window_s=self.window_s,
            by_name=by_name,
            device_ops=[[name[:120], t] for name, (t, _) in ops],
            idle_gaps=[[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
        )
