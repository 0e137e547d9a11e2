"""Roofline analysis on one card (port of ``repro.roofline``'s single-card
half): the H100's constants (``hw``), the three roofline terms and the
analytic model FLOPs (``terms``), and the per-op cost count of a step run
on ``meta`` tensors (``op_costs``, the counterpart of ``hlo_costs``)."""
