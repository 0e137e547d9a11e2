"""The system under test: ``repro_torch``'s batched search, and nothing else.

This is the one module of the benchmark that imports the program. A call is
``repro_torch.core.root_parallel.gscpm_search_batch``; what a call is given
comes from the files alone:

- the search's settings (``GSCPMConfig``) from every key of the
  configuration's file and of the cell's ``search`` object that names one of
  its fields; any other key is refused, except the configuration's
  descriptive keys (``DESCRIPTIVE``);
- the call's keywords (``n_trees``, ``merge_every``, ...) from the cell's
  ``call`` object, passed as they are: the program refuses what it does not
  take;
- a warm start (``forest=``) and the re-root between moves
  (``reroot_forest``) from the traffic kind that asks for them.

What the benchmark reads back of a call is each kept member's answer: its
tree's first ``n_nodes`` rows and its best move.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gscpm import GSCPMConfig
from repro_torch.core.root_parallel import gscpm_search_batch
from repro_torch.core.tree import reroot_forest

DESCRIPTIVE = {"source", "guarantees", "assumed", "precision"}
FIELDS = ("parent", "move", "visits", "wins")


def search_config(config: dict, search: dict) -> GSCPMConfig:
    """``GSCPMConfig`` from a configuration file and a cell's ``search``."""
    names = {f.name for f in dataclasses.fields(GSCPMConfig)}
    kw = {}
    for where, src in (("configuration", config), ("cell's search", search)):
        for k, v in src.items():
            if k in names:
                kw[k] = v
            elif where == "cell's search" or k not in DESCRIPTIVE:
                raise ValueError(f"the {where} names {k!r}, which is no "
                                 "setting of the search")
    return GSCPMConfig(**kw)


class Program:
    def __init__(self, config: dict, params: dict, device):
        self.device = torch.device(device)
        self.cfg = search_config(config, params.get("search", {}))
        self.call = dict(params.get("call", {}))

    def load_kernels(self) -> None:
        """Build (first run in a checkout) or load the kernel library."""
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.load()

    def upload(self, *arrays: np.ndarray):
        """Host arrays on the device."""
        return tuple(torch.as_tensor(a).to(self.device) for a in arrays)

    def search(self, boards, to_move, key: np.ndarray, *, forest=None,
               **settings):
        """One batched call: (forest, stats). ``settings`` replace fields of
        the cell's search for this call (``metrics=True`` turns on the
        program's own device counters, ``stats["metrics"]``)."""
        cfg = dataclasses.replace(self.cfg, **settings)
        key_t = torch.as_tensor(key.astype(np.int64)).to(self.device)
        return gscpm_search_batch(boards, to_move, cfg, key_t, forest=forest,
                                  device=self.device, **self.call)

    @staticmethod
    def reroot(forest, moves):
        """Each member's tree re-rooted at its played move."""
        return reroot_forest(forest, moves)

    def stash(self, forest, stats, members: list[int]) -> dict:
        """The answers of ``members``, copied to the host (the call has
        already waited for the card; a copy kept on the card would raise
        the peak with every call): every row of their trees, their node
        counts and best moves."""
        if not members:
            return {}
        idx = torch.as_tensor(members, device=forest.parent.device)
        out = {f: getattr(forest, f).index_select(0, idx).cpu()
               for f in FIELDS}
        out["n_nodes"] = [int(stats["tree_nodes"][e]) for e in members]
        out["best_move"] = [int(stats["member_best_moves"][e])
                            for e in members]
        return out

    @staticmethod
    def answers(stash: dict) -> list[dict]:
        """A stash as host answers (the reference's fields)."""
        if not stash:
            return []
        host = {f: stash[f].numpy() for f in FIELDS}
        return [{"n_nodes": nn, "best_move": bm,
                 **{f: host[f][j, :nn] for f in FIELDS}}
                for j, (nn, bm) in enumerate(zip(stash["n_nodes"],
                                                 stash["best_move"]))]
