"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. Prints one
JSON line last on standard output (``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` and, traced, ``breakdown``; the compared numbers
with their limits under ``checks``, last) and each compared number beside
its limit last on standard error. Without a card, or on any failure, it
exits non-zero and prints no result.
"""

import time

T0 = time.time()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from slambench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
