"""Workload models (the paper's job profiles) for the port's engine."""
from repro_torch.workload.comm_model import (  # noqa: F401
    PAPER_MODELS,
    CommProfile,
    dp_allreduce_bytes,
    jobspec_from_profiles,
    profile_for,
)
