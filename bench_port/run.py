"""Entry point of the benchmark of ``repro_torch`` (see ``harness.py``).

    python bench_port/run.py --workload lsd-d1d2d3.compact --seed 7 \\
        --seconds 30 --trace 0

Runs from the root of a checkout; the program is ``src/repro_torch``.
"""
import time

T_START = time.perf_counter()           # set-up is timed from here

import ctypes  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def steady_heap() -> None:
    """Serve large arrays from the heap and keep freed memory for the
    next op (glibc ``mallopt``: arrays under 1 GiB are not mmap'd, the
    heap is trimmed only past 2 GiB free and grows 256 MiB at a time).
    Without it every array of a 1.8M-triple graph (over glibc's 32-MiB
    mmap ceiling) is mapped, faulted in page by page and unmapped anew in
    each op, and that kernel work swings with the host's load."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:                     # not glibc: its defaults stand
        return
    for param, value in ((-3, 1 << 30), (-1, (1 << 31) - 1), (-2, 1 << 28)):
        libc.mallopt(param, value)      # M_MMAP_THRESHOLD, _TRIM_, _TOP_PAD


steady_heap()

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache stays inside the checkout, at fixed paths
CACHE = ROOT / "build" / "bench_port_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench_port.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
