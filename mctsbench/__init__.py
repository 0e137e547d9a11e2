"""The benchmark of the PyTorch and CUDA port (``repro_torch``): batched game
search on one card, driven by data.

``python3 mctsbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that belongs
to one item is a file of its own, found by the item's name:

- a configuration: ``configs/<config>.json`` (every key that names a
  setting of the search is passed to it; any other key is refused);
- a cell: ``workloads/<cell>.json``: its traffic kind and parameters, its
  search budget (``search``) and call keywords (``call``), and the cost
  stages (``costs``) and kernel probes (``probes``) its traced run counts;
- a traffic kind: ``traffic/<kind>.py``, whose ``Traffic`` makes the inputs
  from the seed and owns what a call is (``setup``, ``warm_up``, ``step``,
  ``counts``) and which reference judges it (``reference``);
- a metric's reader: ``metrics/<metric>.py``;
- the work of one stage of a sync iteration: ``costs/<stage>.py``;
- the work of one kernel, counted where it is dispatched: ``probes/<name>.py``;
- the plain reference that decides ``correct``: ``reference/``.

Nothing here imports ``jax`` or the JAX package ``repro``; ``reference/``
imports nothing of ``repro_torch`` either.
"""
