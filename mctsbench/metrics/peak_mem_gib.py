"""The card's allocator peak over the whole run (reset at start-up, read
when the window closes), in GiB."""


def read(obs: dict):
    return obs["peak_bytes"] / 2**30 if obs["peak_bytes"] else None
