"""Set-up seconds: from the process's start to the window's: imports and
kernel load, the sample's generation and input file, the warm-up jobs."""


def read(run):
    return run["setup_s"]
