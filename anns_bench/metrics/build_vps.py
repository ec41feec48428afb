"""build_vps: vectors indexed by the window's builds, run back to back,
over the time from the first build's start to the last one's end."""


def read(run):
    if not run.builds:
        return None
    n = sum(b["n"] for b in run.builds)
    return n / (run.builds[-1]["end"] - run.builds[0]["start"])
