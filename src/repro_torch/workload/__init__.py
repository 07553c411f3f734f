"""Workload models (the paper's job profiles) for the port's engine, and
the paper's baseline machinery: compatibility scores, Cassini's
centralized time-shift scheduler and the Table-2 snapshots (numpy, as in
the reference)."""
from repro_torch.workload.comm_model import (  # noqa: F401
    PAPER_MODELS,
    CommProfile,
    dp_allreduce_bytes,
    jobspec_from_profiles,
    profile_for,
)
from repro_torch.workload.compat import (  # noqa: F401
    best_offsets,
    compatibility_score,
)
from repro_torch.workload.cassini import cassini_schedule  # noqa: F401
from repro_torch.workload.snapshots import table2_snapshots  # noqa: F401
