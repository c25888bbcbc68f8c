"""The benchmark of ``boslam_torch`` on one H100: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cells, metrics and bounds are in
``BENCHMARK.json``; each configuration, traffic mix, cell's limits and
metric reader is a file under ``benchmark/`` (``harness/spec.py``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, the numbers that decided ``correct``
beside their limits.  Without a CUDA device it exits with 2 and prints no
result.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


if __name__ == "__main__":
    # build and kernel caches inside the checkout, at fixed paths (the
    # system's own kernels build into build/boslam_torch_kernels)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "benchmark_cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "benchmark_cache" / "triton")
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import runner

    sys.exit(runner.main(t_process=T_PROCESS))
