"""Training on one card (port of ``repro.train``): the step and the
fault-tolerant loop."""
