"""chunk_kernel.us_per_tick: the profiler's device time of the chunk
kernel's launches (``netsim_chunk_kernel*``) per tick of one group."""


def read(view):
    secs = view.kernel_s("netsim_chunk_kernel")
    ticks = view.group_ticks()
    if secs is None or not ticks:
        return None
    return 1e6 * secs / ticks
