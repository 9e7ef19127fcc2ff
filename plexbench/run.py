"""Run one cell of the benchmark once and print its result line.

    python3 plexbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m plexbench.run ...``) from the root of a checkout, on a
machine with the card(s) the cell asks for. See ``plexbench/README.md``.
"""
import os
import sys
import time

T_START = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root and the port's source tree, never plexbench/ itself
# (its module names must not shadow the standard library's)
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
# every compile cache of the run inside the checkout, at fixed paths
_CACHE = os.path.join(ROOT, "build", "plexbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(_CACHE, "inductor")
# a library that would load jax by itself is kept from doing so
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

if __name__ == "__main__":
    from plexbench.harness import main, process_start
    sys.exit(main(t_start=min(process_start(), T_START)))
