"""Serving features built on the search (port of ``repro.serve``)."""
