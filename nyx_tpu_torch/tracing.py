"""Tracing, logging and profiling.

Port of nyx_tpu/tracing.py: `enable_logging` attaches a stderr handler to
the `nyx_tpu_torch` logger (`NYX_LOG` is its default level), `Progress` is
the decile progress line that host loops log through it (the OD host loop,
`od/process.py`), `profile_trace` records the CPU and CUDA activity of
everything run inside it with `torch.profiler` and writes a Chrome trace
into its directory, and `annotate` opens a span.

Spans. `annotate(name, **attrs)` records a span while a `torch.profiler`
profile is running or inside `record_spans()`, and is a shared no-op
otherwise (one flag read; no clock read, no allocation). A recorded span
(`Span`) holds its name, its start and end in Unix nanoseconds (the host's
`perf_counter_ns` shifted by a Unix-clock anchor taken when its outermost
span opens: the clock of the profiler's events, so spans can be laid over
the device trace), its id, its parent (the innermost open span of the same
host thread), its root (the outermost one, shared by every span of one
call into the program), its thread and its attributes. Spans are host
times and never synchronize with a device. They are kept in memory, at
most `SPAN_CAP` of them (`dropped_spans()` counts the rest), read with
`spans()` and emptied with `clear_spans()`. Inside `profile_trace` with
host tracing, a span is also a `torch.profiler.record_function` range, so
it shows on the Chrome timeline.

Usage:
    import nyx_tpu_torch
    nyx_tpu_torch.enable_logging("info")   # or NYX_LOG=debug
    with nyx_tpu_torch.profile_trace("/tmp/trace") as session:
        mc.run_until_epoch(...)
    # session.trace_path: the Chrome trace (chrome://tracing, Perfetto)
    with tracing.record_spans():
        mc.run_until_epoch(...)
    tree = tracing.spans()   # mc.run, mc.draw, integ.step, eom.call, ...
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("nyx_tpu_torch")


def enable_logging(level: str | int | None = None) -> logging.Logger:
    """Attach a stderr handler to the `nyx_tpu_torch` logger (RUST_LOG
    analog; the NYX_LOG env var is the default level, 'warning' otherwise)."""
    if level is None:
        level = os.environ.get("NYX_LOG", "warning")
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname)-5s %(name)s: %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)
    return logger


if os.environ.get("NYX_LOG"):
    enable_logging()


class TraceSession:
    """What `profile_trace` yields: its directory, and after the context
    ends the path of the Chrome trace written there (`trace_path`)."""

    def __init__(self, log_dir: Path):
        self.log_dir = log_dir
        self.trace_path: Path | None = None


@contextlib.contextmanager
def profile_trace(log_dir, host_tracer_level: int = 2, *, cuda: bool | None = None):
    """Profile everything run inside the context with `torch.profiler`: CUDA
    kernels and copies when `cuda` (by default when a card is present), and
    host operations of every thread at `host_tracer_level` (the reference's
    JAX setting: 0 none, 1-2 the operations and `annotate` regions, 3 also
    their input shapes and Python stacks). On exit the Chrome trace is
    written into `log_dir` (created if needed) as `trace-<pid>-<ns>.json`."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = []
    if host_tracer_level > 0:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    verbose = host_tracer_level >= 3
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    # host operations of every thread (a mesh's shards run in threads of their
    # own); CUDA kernels are recorded from every thread either way
    prof = torch.profiler.profile(
        activities=acts, record_shapes=verbose, with_stack=verbose,
        experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))
    session = TraceSession(log_dir)
    host = host_tracer_level > 0
    with prof:
        if host:
            _REC.adjust("ranges", 1)
        try:
            yield session
        finally:
            if host:
                _REC.adjust("ranges", -1)
    path = log_dir / f"trace-{os.getpid()}-{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    session.trace_path = path


#: the most spans kept in memory; those past it are only counted
SPAN_CAP = 1 << 18


class Span(NamedTuple):
    """One recorded span; times in Unix ns, the profiler's clock."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the enclosing span's id on the same thread
    root: int  # the outermost enclosing span's id (its own if outermost)
    thread: str
    attrs: dict


class _Recorder:
    """The process's span state: the open `record_spans` contexts, the open
    `profile_trace` contexts with host tracing (`ranges`: spans then also
    enter `record_function`), each thread's stack of open spans, and the
    store."""

    def __init__(self, cap: int):
        self.depth = 0
        self.ranges = 0
        self.cap = cap
        self.records: list = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()

    def adjust(self, attr: str, by: int):
        with self.lock:
            setattr(self, attr, getattr(self, attr) + by)

    def keep(self, record: tuple):
        with self.lock:
            if len(self.records) < self.cap:
                self.records.append(record)
            else:
                self.dropped += 1


_REC = _Recorder(SPAN_CAP)


def _unix_anchor() -> int:
    """Unix ns minus `perf_counter_ns`, read between two of the latter."""
    a = time.perf_counter_ns()
    unix = time.time_ns()
    b = time.perf_counter_ns()
    return unix - (a + b) // 2


class _LiveSpan:
    __slots__ = ("name", "attrs", "id", "parent", "root", "anchor", "thread", "stack", "range",
                 "start")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        local = _REC.local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        self.id = next(_REC.ids)
        if stack:
            up = stack[-1]
            self.parent, self.root, self.anchor, self.thread = up.id, up.root, up.anchor, up.thread
        else:
            self.parent, self.root, self.anchor = None, self.id, _unix_anchor()
            self.thread = threading.current_thread().name
        stack.append(self)
        self.stack = stack
        self.range = None
        if _REC.ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stack.pop()
        # a tuple of atomic values (None for no attributes), which the garbage
        # collector stops tracking: kept records then cost its later passes
        # nothing; `spans()` makes each a `Span`
        _REC.keep((self.name, self.start + self.anchor, end + self.anchor, self.id, self.parent,
                   self.root, self.thread, self.attrs or None))
        return False

    def set(self, **attrs):
        """Add attributes before the span closes."""
        self.attrs.update(attrs)


class _NoSpan:
    """What `annotate` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        pass


_NO_SPAN = _NoSpan()


def annotate(name: str, **attrs):
    """A span named `name` (a static string) with `attrs`, recorded while a
    `torch.profiler` profile runs or inside `record_spans()`; a shared no-op
    otherwise. Use as `with annotate("integ.step"): ...`; the context's
    value takes more attributes with `.set(key=value)`."""
    if not (_autograd_profiler._is_profiler_enabled or _REC.depth):
        return _NO_SPAN
    return _LiveSpan(name, attrs)


@contextlib.contextmanager
def record_spans():
    """Record spans inside the context, without a profiler."""
    _REC.adjust("depth", 1)
    try:
        yield
    finally:
        _REC.adjust("depth", -1)


def spans() -> list:
    """The recorded spans (`Span`), by start."""
    with _REC.lock:
        out = [Span(*r[:7], r[7] or {}) for r in _REC.records]
    return sorted(out, key=lambda s: (s.start_ns, s.id))


def dropped_spans() -> int:
    """Spans not kept because the store held `SPAN_CAP`."""
    return _REC.dropped


def clear_spans():
    """Empty the store and its dropped count."""
    with _REC.lock:
        _REC.records = []
        _REC.dropped = 0


class Progress:
    """Decile progress reporter for host-side loops.

    Logs at most every `deciles`-th of `total` and not more than once per
    `min_interval_s` of wall clock; always logs the final step.
    """

    def __init__(self, total: int, what: str = "steps", deciles: int = 10,
                 min_interval_s: float = 5.0):
        self.total = max(int(total), 1)
        self.what = what
        self.every = max(self.total // max(deciles, 1), 1)
        self.min_interval_s = min_interval_s
        self._t0 = time.time()
        self._last_log = 0.0

    def step(self, i: int, extra: str = ""):
        """Call with the 0-based index of the just-completed item."""
        done = i + 1
        if done != self.total and done % self.every:
            return
        now = time.time()
        if done != self.total and now - self._last_log < self.min_interval_s:
            return
        self._last_log = now
        elapsed = now - self._t0
        rate = done / elapsed if elapsed > 0 else float("inf")
        msg = f"{100.0 * done / self.total:3.0f}% ({done}/{self.total} {self.what}, {rate:,.1f}/s)"
        if extra:
            msg += f" - {extra}"
        logger.info(msg)

    def done(self, extra: str = ""):
        msg = f"{self.total} {self.what} in {time.time() - self._t0:.2f} s"
        if extra:
            msg += f" - {extra}"
        logger.info(msg)
