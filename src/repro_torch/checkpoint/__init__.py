"""Checkpoint store (port of ``repro.checkpoint``): the flatten helpers the
serving snapshots use; the store itself is ROADMAP.md item A13."""
