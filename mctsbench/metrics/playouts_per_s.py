"""Playouts completed by the window's calls over the window's wall time
(tracing off): every call that started in the window runs to its end."""


def read(obs: dict):
    return obs["playouts"] / obs["window_s"]
