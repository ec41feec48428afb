"""stage1_host_s: mean seconds a build that stage 1's lockstep splitters
spend on the host around K23, popping and splitting nodes, summed over
their worker threads (SplitStats host_s: the ``stage1.host`` spans)."""


def read(run):
    rs = [b["report"] for b in run.builds if b["report"].stage1_split]
    if not rs:
        return None
    return sum(st.host_s for r in rs for st in r.stage1_split) / len(rs)
