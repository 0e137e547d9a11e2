"""Checkpoint store (port of ``repro.checkpoint``): the atomic, async
on-disk store training resumes from, and the flatten helpers the serving
snapshots use."""
