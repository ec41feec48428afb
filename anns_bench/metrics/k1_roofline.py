"""k1_roofline: percent of its roofline that K1 (``ivf_scan_q8_topk``: the
chunk kernel and the merge it launches) reaches: the bound of every
batch's call, from its queries, probes and streamed union
(``roofline.k1_call``), over K1's device time in the trace.  Nothing to
read where K1 did not run, or where B2 ran too: the two launch the same
merge kernel, whose time then belongs to neither alone."""

from anns_bench import roofline


def read(run):
    if run.trace is None or not run.batches:
        return None
    tr = run.trace
    if tr.kernel_s("q8_topk_chunk_kernel") <= 0.0 or \
            tr.kernel_s("f32_topk_kernel") > 0.0:
        return None
    dev = tr.kernel_s("q8_topk_chunk_kernel", "f32_topk_merge_kernel")
    c = run.cell.config
    work = roofline.Work()
    for t, nprobe in run.batches:
        work = work + roofline.k1_call(
            t.size, int(nprobe.sum()), t.union_clusters,
            c["serve"]["nprobe_max"], c["build"]["cluster_len"],
            c["dataset"]["dim"], c["serve"]["n_cand"])
    run.info["k1_roofline"] = {"bound_by": work.bound_by(),
                               "bound_s": work.bound_s(), "device_s": dev}
    return roofline.share_pct(work, dev)
