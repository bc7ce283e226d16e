"""Run one cell of the pymodem_tpu_torch benchmark.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
Prints the setup split, the decode counts and the checks on standard error
and, as the last line of standard output, the result as one JSON object.
"""

import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T0))
