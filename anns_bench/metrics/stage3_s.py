"""stage3_s: mean seconds of build stage 3, LLSP's labelling search and
GBDT fit, over the window's builds (BuildReport.stage_seconds: the
``build.stage3`` span).  In a traced run it also keeps the device's idle
time by the builds' spans for the log (``spans.keep_idle_split``)."""

from anns_bench import spans


def read(run):
    spans.keep_idle_split(run)
    if not run.builds:
        return None
    return sum(b["report"].stage_seconds["stage3"]
               for b in run.builds) / len(run.builds)
