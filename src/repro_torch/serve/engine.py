"""LM serving engines (port of ``repro.serve.engine``): not ported yet.

``SlotEngine`` and ``MCTSSlotEngine`` run on the TPFIFO driver, which is
ROADMAP.md item A10. Until then the names exist and refuse to be built, so
a caller learns which item it waits for. The single-request search-guided
decoder they serve is ``repro_torch.serve.mcts_decode``.
"""

from __future__ import annotations


def _refuse(name: str):
    raise NotImplementedError(
        f"{name}: the serving engines run on the TPFIFO driver, not ported "
        "yet (ROADMAP.md item A10); single-request decoding is "
        "repro_torch.serve.mcts_decode.mcts_generate")


class SlotEngine:
    def __init__(self, *args, **kw):
        _refuse("SlotEngine")


class MCTSSlotEngine:
    def __init__(self, *args, **kw):
        _refuse("MCTSSlotEngine")
