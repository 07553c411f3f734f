#!/usr/bin/env python3
"""What `repro_torch.launch.dryrun.StepCounter`'s memo saves.

    PYTHONPATH=src python3 scripts/dryrun_memo_cost.py

Counts all 40 (architecture x shape) cells on the meta device twice, as
``chip_smoke.py``'s ``dryrun`` phase does (the kernel route, ``rows_that_fit``
included): first as the package runs, each fresh op run once per signature
(`dryrun._RESULTS`), then with that memo emptied on every lookup, so every
op runs.  Prints each pass's seconds and whether the two passes' records
agree on every count.  No card is needed.
"""
import time

from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.launch import dryrun as dr

COUNTS = ("flops_per_device", "bytes_accessed_per_device",
          "argument_bytes_per_device", "temp_bytes_per_device",
          "peak_bytes_per_device", "rows_that_fit", "planned_launches")


class _Forgetful(dict):
    """A memo that never holds anything."""

    def get(self, key, default=None):
        return default

    def __setitem__(self, key, value):
        pass


def count_all() -> tuple[float, dict]:
    t0 = time.perf_counter()
    records = {(arch, shape): dr.run_cell(arch, shape, verbose=False,
                                          plain=False)
               for arch in ARCH_IDS for shape in SHAPES}
    return time.perf_counter() - t0, records


def main() -> None:
    with_memo, a = count_all()
    print(f"with the memo: {with_memo:.1f} s ({dr.summary(a.values())})",
          flush=True)
    dr._RESULTS = _Forgetful()
    without, b = count_all()
    print(f"without it: {without:.1f} s ({dr.summary(b.values())})")
    same = all(a[k].get(c) == b[k].get(c) for k in a for c in COUNTS)
    print(f"counts equal: {same}; the memo saves {without - with_memo:.1f} s "
          f"({without / with_memo:.2f}x)")


if __name__ == "__main__":
    main()
