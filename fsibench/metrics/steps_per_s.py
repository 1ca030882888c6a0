"""steps_per_s: all the steps of the window over all of its seconds (host
clock, from the first step's launch to the last chunk's host read)."""


def read(run):
    return run["steps"] / run["wall_s"] if run["wall_s"] > 0 else None
