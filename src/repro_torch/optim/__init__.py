"""The optimizer (port of ``repro.optim``: AdamW; the int8 gradient
compression waits for the multi-card row of ROADMAP.md, A14c)."""
