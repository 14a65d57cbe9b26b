"""The benchmark's modules import one another by their top-level names
(``python benchmark/run.py`` puts ``benchmark/`` first on the path); the
tests do the same."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
