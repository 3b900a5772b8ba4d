"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of a checkout. Tests that need the card carry the ``card`` marker
and skip, deciding inside the test, where there is none."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without one)")
