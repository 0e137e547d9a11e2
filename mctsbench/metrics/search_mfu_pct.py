"""The whole sync iteration's share of the card's peak: the least time the
card could take for one iteration's counted work (every stage of
``costs/``, counted from what the algorithm needs, whatever implements it),
over ``iteration_ms``'s time."""

from mctsbench.work import least_s


def read(obs: dict):
    stages = obs.get("stage_work")
    if not stages:
        return None
    it = obs["counted_iterations"]
    n_bytes = sum(b for b, _ in stages.values()) / it
    n_ops = sum(o for _, o in stages.values()) / it
    iteration_s = obs["window_s"] / obs["iterations"]
    return 100.0 * least_s(n_bytes, n_ops, obs["peaks"]) / iteration_s
