"""The benchmark's tests import `benchmark` and the port from the checkout's
root; cards are needed only by the tests marked `gpu` (they skip here)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
