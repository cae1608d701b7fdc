"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See perfbench/bench/harness.py for what a run does and BENCHMARK.json for
the cells and metrics.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
