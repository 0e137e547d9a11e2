"""The paper's own experiment configuration (section IV).

Port of ``repro.configs.hex_paper``, on the port's ``GSCPMConfig``. 11x11
Hex, 1,048,576 playouts per move, Cp = 1.0. ``PAPER`` is the full-scale
setting; ``PAPER_CPU`` the small harness default (same shape of the
experiment grid, fewer playouts). ``TASK_SWEEP`` is the paper's task-count
axis (Fig 7/8).

On the GPU the sweep runs at 256 lanes, the width of every Hex phase of
``chip_smoke.py`` (``benchmarks_torch/fig7_speedup.py``); ``PAPER`` keeps
the paper's 244 (61 cores x 4-way SMT) so that it names the same experiment
as the JAX package's.
"""

from repro_torch.core.gscpm import GSCPMConfig

PAPER = GSCPMConfig(
    board_size=11,
    n_playouts=1_048_576,
    n_tasks=4096,           # paper's TPFIFO sweet spot (Fig 7)
    n_workers=244,          # 61 cores x 4-way SMT
    cp=1.0,
    tree_cap=1 << 20,
)

PAPER_CPU = GSCPMConfig(
    board_size=11,
    n_playouts=4096,
    n_tasks=64,
    n_workers=16,
    cp=1.0,
    tree_cap=1 << 14,
)

# the paper's task-count sweep (Fig 7/8 x-axis)
TASK_SWEEP = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
              8192, 16384]
