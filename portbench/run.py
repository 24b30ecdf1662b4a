"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the check lines on standard error and one JSON result line as the
last line of standard output. Exits non-zero without a result when there
is no CUDA card, fewer cards than the cell asks for, or when JAX, flax or
the JAX package were loaded into this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches at fixed paths inside the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "portbench" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "portbench" / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def process_age_s() -> float:
    """Seconds since this process started (from /proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main() -> int:
    age = process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from portbench import bench

    # Every thread off the core that the thread driving the card takes in
    # the window (bench.driving_core), and a fixed number of CPU threads.
    rest, _ = bench.split_cores()
    os.sched_setaffinity(0, rest)
    import torch

    torch.set_num_threads(len(rest))

    cell = bench.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    line = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START - age)
    banned = bench.banned_modules()
    if banned:
        print(f"modules that must not load were loaded: {banned}", file=sys.stderr)
        return 3
    bench.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
