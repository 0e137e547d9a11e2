"""Benchmarks of the PyTorch/CUDA port: the paper's experiments on the card.

Torch twins of ``benchmarks/`` (which stays the JAX package's record):
``table2_sequential``, ``fig5_cilkview``, ``fig7_speedup``,
``fig9_mapping``, ``ablate_vloss`` and ``root_parallel``, driven by
``run`` (``PYTHONPATH=src python -m benchmarks_torch.run``). Results go to
``artifacts/bench_torch/`` and ``BENCH_mcts_torch.json``, each stamped
with the device it ran on.
"""
