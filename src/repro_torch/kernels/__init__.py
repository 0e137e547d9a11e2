"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their wrappers.

Each kernel module holds the wrapper, its launch counter and a re-export of
the plain PyTorch version from ``ref``; ``ops`` is the dispatch the search
calls. Nothing is compiled at import: ``_build`` runs ``nvcc`` at first use.
"""
