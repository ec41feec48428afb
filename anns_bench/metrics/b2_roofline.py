"""b2_roofline: percent of its roofline that B2 (``ivf_scan_topk`` over
the resident f32 postings: the scan kernel and its merge) reaches: the
bound of every batch's call, from its plan's probes and the union of the
clusters they name (``roofline.b2_call``), over B2's device time.
Nothing to read where B2 did not run, or where K1 ran too: the two
launch the same merge kernel."""

import numpy as np

from anns_bench import roofline


def read(run):
    if run.trace is None or not run.plans:
        return None
    tr = run.trace
    if tr.kernel_s("f32_topk_kernel") <= 0.0 or \
            tr.kernel_s("q8_topk_chunk_kernel") > 0.0:
        return None
    dev = tr.kernel_s("f32_topk_kernel", "f32_topk_merge_kernel")
    c = run.cell.config
    work = roofline.Work()
    for cids, pmask, size in run.plans:
        work = work + roofline.b2_call(
            size, int(pmask[:size].sum()),
            int(np.unique(cids[:size][pmask[:size]]).size),
            cids.shape[1], c["build"]["cluster_len"], c["dataset"]["dim"],
            c["serve"]["n_cand"])
    run.info["b2_roofline"] = {"bound_by": work.bound_by(),
                               "bound_s": work.bound_s(), "device_s": dev}
    return roofline.share_pct(work, dev)
