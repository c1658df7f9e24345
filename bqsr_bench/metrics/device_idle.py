"""Share of the traced jobs' wall time in which no kernel, copy or set ran
on the card (profiler device events)."""


def read(run):
    tr = run["trace"]
    if not tr or tr["device_events"] == 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
