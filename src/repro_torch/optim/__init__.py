"""The optimizer (port of ``repro.optim``): AdamW (``adamw``) and the int8
gradient compression of the cross-pod reduce (``compression``)."""
