"""The benchmark's own tests: run from the repository's root with
``python -m pytest portbench/tests``; the root goes on the path so that
``portbench`` and the program import as the harness imports them."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
