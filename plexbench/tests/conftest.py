"""The benchmark's tests: the harness's arithmetic and its run path on the
CPU at a tiny dense preset, the port's kernels in their plain versions.

    python3 -m pytest plexbench/tests -q

Tests marked ``cuda`` decide inside the test whether a card is there.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
