"""The synthetic data pipeline (port of ``repro.data``)."""
