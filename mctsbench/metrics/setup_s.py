"""Process start to the first timed call: imports, the card, the kernel
library (built on a checkout's first run), the position pool and one
warm-up call at the cell's own size."""


def read(obs: dict):
    return obs["setup_s"]
