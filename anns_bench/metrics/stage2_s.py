"""stage2_s: mean seconds of build stage 2 (the streamed closure
assignment of the shards, then the posting lists) over the window's builds
(BuildReport.stage_seconds)."""


def read(run):
    if not run.builds:
        return None
    return sum(b["report"].stage_seconds["stage2"]
               for b in run.builds) / len(run.builds)
