"""setup_s: from the process's start to the window's first step: the
imports, the kernels' build where the checkout has none, the step, the
initial state and the warm-up chunk (host clock)."""


def read(run):
    return run["setup_s"]
