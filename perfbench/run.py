"""One run of one benchmark cell of the PyTorch port:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic
driver and its per-layer metric readers are found by name under
``perfbench/`` (``harness/cell.py``). The last line of standard output is
the result as one JSON object; the numbers compared with the plain
reference, each beside its limit, are the last lines of standard error.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this directory, is where imports start
sys.path[0] = ROOT
# every cache the run writes stays at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "perfbench", sub)

from perfbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
