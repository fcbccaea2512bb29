"""Tracing, logging and profiling.

Port of nyx_tpu/tracing.py: `enable_logging` attaches a stderr handler to
the `nyx_tpu_torch` logger (`NYX_LOG` is its default level), `Progress` is
the decile progress line that host loops log through it (the OD host loop,
`od/process.py`), `profile_trace` records the CPU and CUDA activity of
everything run inside it with `torch.profiler` and writes a Chrome trace
into its directory, and `annotate` names a region on that timeline
(`torch.profiler.record_function`).

Usage:
    import nyx_tpu_torch
    nyx_tpu_torch.enable_logging("info")   # or NYX_LOG=debug
    with nyx_tpu_torch.profile_trace("/tmp/trace") as session:
        mc.run_until_epoch(...)
    # session.trace_path: the Chrome trace (chrome://tracing, Perfetto)
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from pathlib import Path

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
    import torch

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
    with prof:
        yield session
    path = log_dir / f"trace-{os.getpid()}-{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    session.trace_path = path


def annotate(name: str):
    """A named region on the profiler timeline (`record_function`)."""
    import torch

    return torch.profiler.record_function(name)


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
