"""Benchmark of the PyTorch/CUDA port's batched sweep: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. See ``portbench/harness.py``.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``portbench``) and its ``src`` (the port), not
# this script's folder
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
# the port builds its kernels into build/repro_torch inside the checkout,
# a fixed path, on a checkout's first run

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
