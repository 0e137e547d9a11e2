"""LM serving engines (port of ``repro.serve.engine``): not ported yet.

``SlotEngine`` and ``MCTSSlotEngine`` are the LM engines on the TPFIFO
driver; ``TPFIFODriver`` itself is ported (``repro_torch.serve.tpfifo``), the LM
engines are ROADMAP.md item A10 (LM half), after A12b. Until then the
names exist and refuse to be built, so a caller learns which item it waits
for. The single-request search-guided decoder they serve is
``repro_torch.serve.mcts_decode``; board-game search serves through
``repro_torch.serve.games``.
"""

from __future__ import annotations


def _refuse(name: str):
    raise NotImplementedError(
        f"{name}: the LM serving engines are not ported yet (ROADMAP.md "
        "item A10 (LM half)); single-request decoding is "
        "repro_torch.serve.mcts_decode.mcts_generate")


class SlotEngine:
    def __init__(self, *args, **kw):
        _refuse("SlotEngine")


class MCTSSlotEngine:
    def __init__(self, *args, **kw):
        _refuse("MCTSSlotEngine")
