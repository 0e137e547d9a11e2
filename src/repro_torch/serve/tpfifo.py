"""The TPFIFO serving driver and its LM engines (port of
``repro.serve.tpfifo``): not ported yet, ROADMAP.md item A10. The names
exist and refuse to be built, naming the item."""

from __future__ import annotations


def _refuse(name: str):
    raise NotImplementedError(
        f"{name}: the TPFIFO driver and its engines are not ported yet "
        "(ROADMAP.md item A10)")


class TPFIFODriver:
    def __init__(self, *args, **kw):
        _refuse("TPFIFODriver")


class TPFIFOEngine(TPFIFODriver):
    def __init__(self, *args, **kw):
        _refuse("TPFIFOEngine")


class TPFIFOMCTSEngine(TPFIFODriver):
    def __init__(self, *args, **kw):
        _refuse("TPFIFOMCTSEngine")
