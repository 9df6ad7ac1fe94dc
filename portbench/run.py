"""The benchmark of ``ccd_tpu_torch`` on one NVIDIA GPU: one cell of
``BENCHMARK.json`` per run (a cell on more than one card is refused).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

prints, as its last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device``; the
numbers that decided ``correct`` are its last key and the last lines of
standard error. ``--rehearse`` runs the cell's traffic kind on the CPU at the
configuration's small rehearsal sizes (no device metric, no cell).
"""

import os
import sys
import time

STARTED = time.time()  # set-up counts from here

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# import the harness as the package ``portbench`` from the checkout's root,
# never its files as top-level modules
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
