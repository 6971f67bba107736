"""Run one cell of BENCHMARK.json on the CUDA device of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line as the last line of standard output (``harness.py``)
and exits 0; exits non-zero with no result when there is no CUDA device,
when the check of the outputs cannot run, or when JAX or the JAX package was
loaded.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == '__main__':
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark import harness
    harness.set_cache_dirs()
    sys.exit(harness.main(sys.argv[1:], T_START))
