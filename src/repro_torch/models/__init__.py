"""Dense decoder-only LM (port of the dense half of ``repro.models``)."""
