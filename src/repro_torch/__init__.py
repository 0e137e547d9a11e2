"""PyTorch + CUDA port of the GSCPM search stack (NVIDIA Hopper).

Mirrors the layout and public names of the JAX package ``repro`` so every
function has a findable counterpart (``repro_torch.core.gscpm.gscpm_search``
is the port of ``repro.core.gscpm.gscpm_search``). This package imports
``torch`` and ``numpy`` only.

Two rules hold everywhere:

- **Device.** Every entry point takes ``device=None`` and ``None`` means
  ``torch.device("cuda")``; callers that want the CPU say so.
- **RNG.** Random streams are explicit threefry keys (``repro_torch.rng``),
  bit-identical to ``jax.random`` under the typed-key partitionable
  threefry, so the port can be held against the JAX package on identical
  streams.
"""
