"""group_edge.idle_ms_per_group: the card's idle time outside the chunk
loops, per group: the gaps between device records whose midpoint lies in
no ``loop`` span of the program (`harness.program_spans`: a group's
parameters, set-up, drain, fetch and post-processing, and the time
between plans), over the window's ``group`` spans.  Milliseconds."""
from harness import program_spans


def read(view):
    spans = program_spans.spans(view)
    gaps = program_spans.idle_gaps(view)
    if spans is None or gaps is None:
        return None
    groups = sum(1 for s in spans.values() if s.name == "group")
    if not groups:
        return None
    return 1e-6 * sum(ns for ns, path in gaps if "loop" not in path) / groups
