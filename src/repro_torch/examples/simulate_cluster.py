"""End-to-end run (the paper's kind): the framework's own training jobs
compete for a shared 50 Gbps DCN link; MLTCP (MLQCN) vs default DCQCN.

The port of ``examples/simulate_cluster.py``.  Each job's traffic profile
(per-iteration bytes = its cross-pod gradient all-reduce; compute gap =
its roofline step time) is derived from the real architecture configs.
The port reckons the compute gaps on the H100's constants
(`cluster.simulate_shared_cluster`'s default ``hw=H100``, from
``roofline/hw.py``), where the reference reckons them on its TPU's, so
the two scripts' iteration times differ by that ratio.  On the card each
scheme is one run of the chunk kernel; ``--sim-time`` cuts the run.

    PYTHONPATH=src python -m repro_torch.examples.simulate_cluster
"""
from __future__ import annotations

import argparse

from repro_torch.cluster import ClusterReport, simulate_shared_cluster

JOBS = ["qwen3-1.7b", "qwen3-1.7b", "olmo-1b"]
SIM_TIME = 4.0


def main(argv=None) -> ClusterReport:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sim-time", type=float, default=SIM_TIME,
                    help="simulated seconds (default %(default)s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rep = simulate_shared_cluster(JOBS, algo="dcqcn", sim_time=args.sim_time,
                                  device=args.device)
    print(f"jobs: {rep.jobs}")
    for j, (b, m) in enumerate(zip(rep.baseline_avg, rep.mltcp_avg)):
        print(f"  {rep.jobs[j]:24s} iter {b * 1e3:7.2f} ms -> "
              f"{m * 1e3:7.2f} ms")
    print(f"avg speedup {rep.avg_speedup:.2f}x  p99 {rep.p99_speedup:.2f}x")
    print(f"comm-phase overlap {rep.interleave_before:.2f} -> "
          f"{rep.interleave_after:.2f} (0 = interleaved)")
    return rep


if __name__ == "__main__":
    main()
