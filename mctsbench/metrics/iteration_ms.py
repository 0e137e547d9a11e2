"""Wall milliseconds of one sync iteration: the window's wall time over the
sync iterations its calls ran (tracing off)."""


def read(obs: dict):
    return 1e3 * obs["window_s"] / obs["iterations"]
