"""Job favoritism policies — paper §3.2.

Any policy that *reinforces* Shortest-Remaining-Processing-Time stabilizes
into an interleaved state; any policy that cancels SRPT does not.  MLTCP
uses ``bytes_sent / total_bytes`` because it is computable locally at the
sender.  Each policy maps per-flow observables to a score in [0, 1]; F is
applied to that score instead of the raw bytes_ratio.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FlowObservables:
    """Per-flow quantities available when computing the favoritism score.

    bytes_ratio      : bytes_sent / total_bytes of the current iteration.
    iter_start_ago   : time since this iteration's comm phase started,
                       normalized by the job's period.
    est_finish_in    : estimated time until the iteration's comm finishes,
                       normalized.
    """

    bytes_ratio: Tensor
    iter_start_ago: Tensor
    est_finish_in: Tensor


PolicyFn = Callable[[FlowObservables], Tensor]


# --- SRPT-reinforcing policies (paper: these all interleave) ---------------

def largest_data_sent(obs: FlowObservables) -> Tensor:
    """MLTCP's default: favor the flow with the largest fraction sent."""
    return obs.bytes_ratio


def smallest_data_remaining(obs: FlowObservables) -> Tensor:
    return 1.0 - (1.0 - obs.bytes_ratio)  # == bytes_ratio; kept for clarity


def earliest_iter_start(obs: FlowObservables) -> Tensor:
    return torch.clamp(obs.iter_start_ago, 0.0, 1.0)


def earliest_iter_finish(obs: FlowObservables) -> Tensor:
    return 1.0 - torch.clamp(obs.est_finish_in, 0.0, 1.0)


# --- SRPT-canceling policies (paper: these all FAIL to interleave) ---------

def smallest_data_sent(obs: FlowObservables) -> Tensor:
    return 1.0 - obs.bytes_ratio


def largest_data_remaining(obs: FlowObservables) -> Tensor:
    return 1.0 - obs.bytes_ratio


def latest_iter_start(obs: FlowObservables) -> Tensor:
    return 1.0 - torch.clamp(obs.iter_start_ago, 0.0, 1.0)


def latest_iter_finish(obs: FlowObservables) -> Tensor:
    return torch.clamp(obs.est_finish_in, 0.0, 1.0)


REINFORCING = {
    "largest_data_sent": largest_data_sent,
    "smallest_data_remaining": smallest_data_remaining,
    "earliest_iter_start": earliest_iter_start,
    "earliest_iter_finish": earliest_iter_finish,
}

CANCELING = {
    "smallest_data_sent": smallest_data_sent,
    "largest_data_remaining": largest_data_remaining,
    "latest_iter_start": latest_iter_start,
    "latest_iter_finish": latest_iter_finish,
}

ALL_POLICIES = {**REINFORCING, **CANCELING}

# the policies that read the time observables (the engine computes those
# only when the configured policy needs them)
TIME_BASED = frozenset({"earliest_iter_start", "earliest_iter_finish",
                        "latest_iter_start", "latest_iter_finish"})


def get_policy(name: str) -> PolicyFn:
    try:
        return ALL_POLICIES[name]
    except KeyError as e:
        raise ValueError(f"unknown favoritism policy {name!r}; "
                         f"choose from {sorted(ALL_POLICIES)}") from e
