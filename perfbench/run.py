#!/usr/bin/env python3
"""Run one cell of the port's benchmark:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for (see ``perfbench/harness.py``). The last line of standard output
is the run's result as one JSON object; the numbers compared to decide
``correct`` close standard error and the line's ``checks``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
