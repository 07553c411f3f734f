"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card: set-up and warm-up, a
window of ``--seconds`` seconds of the cell's traffic, then the
comparison with the plain reference that decides ``correct``.  With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy time and a
breakdown (`harness.context`).  Builds and caches stay inside the
checkout (``build/kernels``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare(args) -> None:
    """The environment the program needs, before torch loads."""
    if args.trace:
        # a fresh CUPTI state for the traced session (harness.trace)
        os.environ["TEARDOWN_CUPTI"] = "1"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    for path in (str(ROOT / "src"), str(HERE)):
        if path not in sys.path:
            sys.path.insert(0, path)


def main(argv=None) -> int:
    args = parse(argv)
    prepare(args)
    from harness import context

    return context.main(args, T_START, ROOT)


if __name__ == "__main__":
    sys.exit(main())
