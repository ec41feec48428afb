"""stage1_s: mean seconds of build stage 1 (coarse clustering: the
lockstep splitters, K23, then the size bound) over the window's builds
(BuildReport.stage_seconds)."""


def read(run):
    if not run.builds:
        return None
    return sum(b["report"].stage_seconds["stage1"]
               for b in run.builds) / len(run.builds)
