"""The port's benchmark: one run of one cell on the card this process is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's checks on standard error and, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``breakdown``), then ``checks``. Exits non-zero, with no such line, where there is no CUDA card
(or fewer than the cell asks for), where the program (``vo_tpu_torch``) is not beside this
folder, or where the process holds JAX or the JAX package after the window. See
perfbench/README.md and perfbench/harness.py.
"""
import time

T_START = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
