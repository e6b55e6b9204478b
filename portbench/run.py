"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``g2vec_tpu_torch``. The last line
of standard output is the result's JSON object. It exits non-zero, and
prints no result, without a CUDA device.
"""
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
