"""chunk_kernel_roofline: the chunk kernel's share of its roofline.

The least time the card could take for the window's launches, the larger
of their operations at the float32 peak and their bytes at the memory
peak (`harness.costs`, from each launch's shapes; `harness.peaks`, the
published peaks of the card), over the kernel's device time.  Percent."""
from harness import costs


def read(view):
    secs = view.kernel_s("netsim_chunk_kernel")
    if not secs or not view.launches:
        return None
    bound = 0.0
    for ln in view.launches:
        flops = costs.flops_per_launch(ln["algo"], ln["K"], ln["N"],
                                       ln["M"], ln["J"], ln["T"])
        nbytes = costs.bytes_per_launch(ln["algo"], ln["K"], ln["N"],
                                        ln["M"], ln["J"], ln["T"], ln["D"],
                                        ln["P"])
        bound += ln["count"] * max(flops / view.peaks["f32_flops"],
                                   nbytes / view.peaks["hbm_bytes"])
    return 100.0 * bound / secs
