"""The Hex playout kernel's share of its roofline: the least time of the
work its probe counted, over the kernel's device time in the profiled
call."""

from mctsbench.work import kernel_roofline


def read(obs: dict):
    return kernel_roofline(obs, "hex_playout")
