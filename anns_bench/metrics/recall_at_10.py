"""recall_at_10: recall@10 of every answer completed within the window
against the exact top-10 of the whole corpus (the reference's brute force,
float32 with TF32 off)."""


def read(run):
    if run.ids is None or run.gt is None:
        return None
    m = run.ok & (run.done <= run.window[1])
    if not m.any():
        return None
    got = run.ids[m][:, :10]
    want = run.gt[run.rows[m]][:, :10]
    hits = (want[:, :, None] == got[:, None, :]).any(-1).sum()
    return float(hits) / want.size
