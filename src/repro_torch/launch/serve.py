"""Serving CLI (port of ``repro.launch.serve``): not ported yet.

Every LM mode of the reference's launcher serves through ``TPFIFODriver``
(ROADMAP.md item A10), and its ``--mcts-game`` mode through the game engine
(A10 too); a port that called ``mcts_generate`` instead would compute
something other than the reference. Until A10 lands ``main`` refuses.
"""

from __future__ import annotations


def main(argv=None):
    raise NotImplementedError(
        "launch/serve.py: every mode serves through the TPFIFO driver, not "
        "ported yet (ROADMAP.md item A10); single-request search-guided "
        "decoding is repro_torch.serve.mcts_decode.mcts_generate")


if __name__ == "__main__":
    main()
