"""The share of the profiled call's window in which no operation ran on the
card: 1 - (union of the device operations' intervals) / window."""


def read(obs: dict):
    tr = obs.get("trace")
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr else None
