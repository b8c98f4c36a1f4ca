"""One run of one benchmark cell of the PyTorch port (``geomx_tpu_torch``).

    python3 gxbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout; see ``gxbench/README.md``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    from gxbench import harness
    sys.exit(harness.main(sys.argv[1:], T0))
