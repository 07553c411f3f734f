"""chunk_inputs.us_per_tick: host time in `engine.chunk_inputs` (the
draws of `kernels.netsim_chunk.host_draws`, the copy to the card and the
chunk's time and start masks), by the spans around each call, per tick
of one group."""


def read(view):
    ticks = view.group_ticks()
    if not ticks or not view.spans.count("chunk_inputs"):
        return None
    return 1e6 * view.spans.total_s("chunk_inputs") / ticks
