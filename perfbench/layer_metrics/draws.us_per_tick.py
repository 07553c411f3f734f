"""draws.us_per_tick: host time in the draw call alone (the kernel
library's C loop, `kernels.netsim_chunk.host_draws`), by the program's
``draws`` spans (`harness.program_spans`), per group-tick they drew."""
from harness import program_spans


def read(view):
    spans = program_spans.spans(view)
    if spans is None:
        return None
    draws = [s for s in spans.values() if s.name == "draws"]
    ticks = sum(s.count for s in draws)
    if not ticks:
        return None
    return 1e-3 * sum(s.end - s.start for s in draws) / ticks
