"""Progress logging for host-side loops.

Port of `Progress` from nyx_tpu/tracing.py:77-117: the decile progress line
that the OD host loop (`od/process.py`) logs through the `nyx_tpu_torch`
logger. Not ported yet (ROADMAP Queue 1 item 7): the rest of the
reference's module, `enable_logging`, `profile_trace` and `annotate`, whose
counterparts here would wrap `torch.profiler` and
`torch.profiler.record_function`.
"""

from __future__ import annotations

import logging
import time

logger = logging.getLogger("nyx_tpu_torch")


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
