"""Does the profiler keep every device record late in a long process?

Traces the same 303 kernels (300 small adds, 3 matmuls) in a series of
`torch.profiler` sessions: two at start, then after each of ROUNDS rounds
of BUSY seconds of matmuls, three back to back whose edges pause 2.0,
0.1 and 0.0 s around the work.  Each session prints one JSON line: the
process's age, the pause, the device records it kept (`n` of `want`),
and how far the first record's start and the last record's end lie from
the host's launch and synchronize times (ms).  Then TAIL seconds of
matmuls: with TEARDOWN_CUPTI=1 a session's CUPTI teardown completes in
a later CUDA call, and a process that makes none after its last session
does not exit (`--tail 0` shows it).

    python scripts/cupti_probe.py A 8 40 &
    TEARDOWN_CUPTI=1 python scripts/cupti_probe.py B 8 40 &
    wait

Needs a CUDA card; the two processes may share it.
"""
import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag", help="a name printed on every line")
    ap.add_argument("rounds", type=int)
    ap.add_argument("busy", type=float, help="seconds of matmuls a round")
    ap.add_argument("--tail", type=float, default=10.0,
                    help="seconds of matmuls after the last session")
    args = ap.parse_args()

    x = torch.randn(2048, 2048, device="cuda")
    small = torch.zeros(1024, device="cuda")
    t0 = time.time()

    def probe(margin: float, n_small: int = 300) -> None:
        torch.cuda.synchronize()
        w0 = time.time_ns()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            torch.cuda.synchronize()
            time.sleep(margin)
            h0 = time.time_ns()
            for _ in range(n_small):
                small.add_(1.0)
            for _ in range(3):
                x @ x
            torch.cuda.synchronize()
            h1 = time.time_ns()
            time.sleep(margin)
        kr = p.profiler.kineto_results
        evs = [e for e in kr.events() if e.device_type() == DeviceType.CUDA]
        st = [e.start_ns() for e in evs]
        en = [e.start_ns() + e.duration_ns() for e in evs]
        print(json.dumps(dict(
            tag=args.tag, age_s=round(time.time() - t0, 1), margin=margin,
            n=len(evs), want=n_small + 3,
            first_minus_launch_ms=(min(st) - h0) / 1e6 if st else None,
            last_minus_sync_ms=(max(en) - h1) / 1e6 if en else None,
            trace_start_minus_w0_ms=(kr.trace_start_ns() - w0) / 1e6)),
            flush=True)

    def busy(seconds: float) -> None:
        t = time.time()
        while time.time() - t < seconds:
            for _ in range(50):
                x @ x
            torch.cuda.synchronize()

    probe(2.0)
    probe(0.1)
    for _ in range(args.rounds):
        busy(args.busy)
        time.sleep(5)
        probe(2.0)
        probe(0.1)
        probe(0.0)
    busy(args.tail)


if __name__ == "__main__":
    main()
