"""Kernels the card ran (memory copies and sets left out) in the profiled
call, over the sync iterations of that call."""


def read(obs: dict):
    tr = obs.get("trace")
    return tr.n_kernels / obs["traced_iterations"] if tr else None
