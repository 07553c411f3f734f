"""The chunk kernel's operations and bytes, from a launch's shapes.

What the algorithm needs for one launch of T ticks of K points with N
flows, M links, J jobs, a feedback ring of D ticks and P phases, for the
simulator's Reno or DCQCN tick (`reference.fluid`):

* operations: the float arithmetic of one tick of `reference.fluid`
  (add, subtract, multiply, divide, min, max, the loss and CNP
  probability's exp), counted per element of the arrays it runs on, and
  the trace epilogue of the chunk; comparisons and selects are not
  counted;
* bytes: each input byte read once (the tick's time, start and straggle
  flags, the loss uniforms and, for DCQCN, the CNP uniforms, the
  straggle amounts; the run's constants), the state read once and
  written once, and the chunk's traces written once.  Iteration times
  written as iterations end (a few a job per run) are left out: they are
  under 0.01% of the bytes.
"""
from __future__ import annotations


def _ecn(algo: str) -> bool:
    return algo == "dcqcn"


def flops_per_tick(algo: str, N: int, M: int, J: int) -> int:
    """Float operations of one tick of one point."""
    ecn = _ecn(algo)
    per_flow = (3 + (0 if ecn else 1)       # rate, rate * dt, min, sub
                + 4 + (4 if ecn else 0)     # loss (CNP) probability
                + 1 + 2 + 1                 # retransmit, to_deliver, quota
                + 18                        # Algorithm 1, F
                + (27 if ecn else 11)       # DCQCN or Reno update
                + 2 + (1 if ecn else 0))    # drop (mark), byte accounting
    per_link_flow = 12 + (2 if ecn else 0)
    per_link = 16 + (0 if ecn else 2)
    per_job = 3
    return (per_flow * N + per_link_flow * M * N + per_link * M
            + per_job * J)


def flops_per_launch(algo: str, K: int, N: int, M: int, J: int,
                     T: int) -> int:
    epilogue = M + J + N + J                # util, throughput, ratio
    return K * (T * flops_per_tick(algo, N, M, J) + epilogue)


def bytes_per_launch(algo: str, K: int, N: int, M: int, J: int, T: int,
                     D: int, P: int) -> int:
    ecn = _ecn(algo)
    inputs = T * (4 + J + 4 * N * (2 if ecn else 1) + J + 4 * J)
    cc_words = 7 if ecn else 3
    state = (4 * N * (cc_words + 5 + 3)     # CC, Algorithm 1, flow bytes
             + 4 * 2 * M * N                # queues and bytes in transit
             + 4 * D * N + 2 * D * N        # feedback ring
             + 21 * J + 4)                  # phase machines, tick
    consts = 4 * (8 + N + 2 * J * P + M) + J
    traces = 4 * (M + 3 + 2 * J) + J
    return K * (inputs + 2 * state + consts + traces)
