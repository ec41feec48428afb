"""k23_roofline: percent of its roofline that K23 (``kmeans_batched``)
reaches over the window's builds: the bound of every launch, from the
sub-problem sizes and iterations it was given (``roofline.k23_call``),
over the kernel's device time in the trace."""

from anns_bench import roofline


def read(run):
    if run.trace is None or not run.k23:
        return None
    dev = run.trace.kernel_s("kmeans_batched_kernel")
    if dev <= 0.0:
        return None
    work = roofline.Work()
    for sizes, ks, dim, iters in run.k23:
        work = work + roofline.k23_call(sizes, ks, dim, iters)
    run.info["k23_roofline"] = {"bound_by": work.bound_by(),
                                "bound_s": work.bound_s(), "device_s": dev}
    return roofline.share_pct(work, dev)
