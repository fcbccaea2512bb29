"""The benchmark's own tests: `python -m pytest -q portbench/tests` from the
repository's root (CPU); `-m cuda` runs the card-only ones on a card."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
