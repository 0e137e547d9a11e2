"""Serving engine (port of ``repro.serve.engine``): prefill/decode steps and
slot-based continuous batching.

``make_prefill_step`` / ``make_serve_step`` are the model's prefill and
one-token decode as plain callables. ``SlotEngine`` is the host-side
batcher: a fixed pool of B slots, each holding one request's position;
finished slots are refilled from the queue with no change of shape.

``MCTSSlotEngine`` is the search-guided sibling (DESIGN.md §3/§4): the same
fixed pool of B slots, but every slot owns a GSCPM token tree and each
engine tick runs ONE root-parallel batched search
(``mcts_decode.mcts_decode_search_batch`` — all slots advance as one
forest) and commits one searched token per active slot. Empty slots ride
along as masked requests, so arrival patterns never change shapes.

Both engines are *lockstep policies* (one micro-step per tick, admission
only into free slots, no preemption) over the work-sharing FIFO driver in
``repro_torch.serve.tpfifo``, which owns the queue discipline, admission
bookkeeping, and per-request telemetry (``QueueStats``). The
grain-size-controlled engines — ``TPFIFOEngine`` / ``TPFIFOMCTSEngine`` —
live there too.

The JAX package keeps a process-wide ``lru_cache`` of jitted prefill and
decode functions (``_shared_prefill`` / ``_shared_decode``) so that
compiled programs outlive the engines. Without jit there is nothing to
keep: here the two are the plain step callables, kept under the same names.
``device=None`` means CUDA for both engines; ``params`` must lie on the
engine's device. The KV cache is updated in place where the JAX package
donates it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import rng
from repro_torch.models import api
from repro_torch.models.common import ModelConfig
from repro_torch.serve.tpfifo import (TPFIFODriver, Ticket, cache_batch_axes,
                                      cache_leaves, sample_tokens)  # noqa: F401  (sample_tokens re-exported, as the JAX package does)


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    """(params, batch) -> (last-position logits, cache tree)."""

    def prefill_step(params, batch: dict):
        return api.prefill(params, cfg, batch, max_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One-token decode for the whole slot batch.

    tokens: (B, 1) i32; pos: an int or a (B,) i32 tensor; the cache is
    written in place and returned. Logits out: (B, 1, V).
    """

    def serve_step(params, tokens, pos, cache):
        return api.decode(params, cfg, tokens, pos, cache)

    return serve_step


def _shared_prefill(cfg: ModelConfig, max_len: int) -> Callable:
    """The prefill step (a jitted, process-wide cached function in the JAX
    package; a plain callable here: there is no compiled program to keep)."""
    return make_prefill_step(cfg, max_len)


def _shared_decode(cfg: ModelConfig) -> Callable:
    """The decode step (see ``_shared_prefill``)."""
    return make_serve_step(cfg)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int = 32
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class SlotEngine(TPFIFODriver):
    """Fixed-B continuous batcher over the prefill/decode steps.

    Per-slot prefill (batch 1: on the card the flash kernel) writes the
    prompt's KV into the slot's rows of the shared cache; all active slots
    then decode in lockstep at their own positions. The batch shape is
    constant whatever the arrival pattern — a FIFO worker pool (requests
    queue; a free slot takes the head of the queue).
    """

    def __init__(self, params, cfg: ModelConfig, n_slots: int, max_len: int,
                 temperature: float = 0.0, eos_id: int = 2, seed: int = 0,
                 tracer=None, registry=None, device=None):
        super().__init__(n_slots, tracer=tracer, registry=registry)
        self.device = (torch.device("cuda") if device is None
                       else torch.device(device))
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.key = rng.key(seed, self.device)

        self.cache = api.init_cache(cfg, n_slots, max_len, device=self.device)
        # cache leaves are layer-stacked: each leaf's batch axis, so
        # per-slot copies index the right dimension
        self._batch_axes = cache_batch_axes(cfg, n_slots, max_len)
        self.pos = np.zeros((n_slots,), np.int32)       # next write position
        self._pending_admits: list[tuple[int, Ticket]] = []
        self._prefill1 = _shared_prefill(cfg, max_len)  # batch 1 per request
        self._decode = _shared_decode(cfg)
        self._pending_tok = np.zeros((n_slots, 1), np.int32)

    def submit(self, req: Request, at: float | None = None):
        if len(req.prompt) > self.max_len:
            raise ValueError(
                f"prompt ({len(req.prompt)}) exceeds the cache "
                f"(max_len {self.max_len}); generation past the cache is "
                f"merely truncated, but an oversized prompt cannot prefill")
        super().submit(req, at=at)

    def _should_retire(self, tok: int, req: Request, pos: int) -> bool:
        """Shared by the admission and decode paths — the two must agree."""
        return (tok == self.eos_id or len(req.out) >= req.max_new
                or pos >= self.max_len - 1)

    # ------------------------------------------------------------- admit ----
    def _load_slot(self, s: int, t: Ticket):
        # defer device work: a tick's admissions are applied together
        self._pending_admits.append((s, t))

    def _apply_admits(self):
        big_leaves = cache_leaves(self.cache)
        for s, t in self._pending_admits:
            req = t.req
            toks = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                   device=self.device)[None, :]
            logits, cache1 = self._prefill1(self.params, {"tokens": toks})
            # copy the single-request cache into slot s (per-leaf batch axis)
            for big, one, bi in zip(big_leaves, cache_leaves(cache1),
                                    self._batch_axes):
                big.select(bi, s).copy_(one.select(bi, 0))
            self.key, k = rng.split(self.key)
            tok = sample_tokens(logits, k, self.temperature)
            tok_i = int(tok[0, 0])
            req.out.append(tok_i)
            self._pending_tok[s] = tok_i
            self.pos[s] = len(req.prompt)
            # the admission token can already satisfy the request (eos, a
            # max_new=1 budget, or a full cache): retire now, or the next
            # decode tick would overrun the budget
            if self._should_retire(tok_i, req, int(self.pos[s])):
                self._retire_slot(s)
        self._pending_admits = []

    # -------------------------------------------------------------- step ----
    def step(self) -> int:
        """One engine tick: admit, decode all active slots, retire finished."""
        self._admit_free_slots()
        if self._pending_admits:
            self._apply_admits()
        if not any(t is not None for t in self.active):
            return 0
        tokens = torch.as_tensor(self._pending_tok, device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.cache = self._decode(self.params, tokens, pos, self.cache)
        self.key, k = rng.split(self.key)
        nxt = sample_tokens(logits, k, self.temperature).cpu().numpy()
        n_active = 0
        for s, t in enumerate(self.active):
            if t is None:
                continue
            n_active += 1
            req = t.req
            tok = int(nxt[s, 0])
            req.out.append(tok)
            self.pos[s] += 1
            self._pending_tok[s] = tok
            if self._should_retire(tok, req, int(self.pos[s])):
                self._retire_slot(s)
        return n_active


class MCTSSlotEngine(TPFIFODriver):
    """Multi-user MCTS-decode server: B slots, B trees, one forest.

    Each tick = admit waiting requests into free slots, run one batched
    GSCPM search over ALL active slots' prompts (each slot's tree is an
    independent member of one forest; see ``mcts_decode_search_batch``),
    commit each slot's most-visited root token, retire finished requests.

    The token buffer is a fixed (B, max_prompt_len) host matrix and prompt
    lengths are run-time values, so admissions, commits, and retirements
    never change a shape. ``max_prompt_len`` must cover every request's
    prompt PLUS its ``max_new`` generated tokens (enforced at submit).
    """

    def __init__(self, params, cfg: ModelConfig, dcfg, n_slots: int,
                 max_prompt_len: int, eos_id: int = 2, seed: int = 0,
                 tracer=None, registry=None, device=None):
        super().__init__(n_slots, tracer=tracer, registry=registry)
        self.device = (torch.device("cuda") if device is None
                       else torch.device(device))
        self.params = params
        self.cfg = cfg
        self.dcfg = dcfg
        self.max_prompt_len = max_prompt_len
        self.eos_id = eos_id
        self.key = rng.key(seed, self.device)

        self.tokens = np.zeros((n_slots, max_prompt_len), np.int32)
        self.lens = np.ones((n_slots,), np.int32)   # >=1: masked slots still
        # bounded tick history: a long-lived server must not grow host
        # memory with one dict per committed token
        self.search_stats: collections.deque = collections.deque(maxlen=256)

    def submit(self, req: Request, at: float | None = None):
        if len(req.prompt) + req.max_new > self.max_prompt_len:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new ({req.max_new}) "
                f"exceeds max_prompt_len ({self.max_prompt_len})")
        super().submit(req, at=at)

    def _load_slot(self, s: int, t: Ticket):
        req = t.req
        L = len(req.prompt)
        self.tokens[s, :] = 0
        self.tokens[s, :L] = np.asarray(req.prompt, np.int32)
        self.lens[s] = L

    def step(self) -> int:
        """One tick: admit, search all slots in lockstep, commit one token
        per active slot, retire finished. Returns #active slots served."""
        from repro_torch.serve.mcts_decode import mcts_decode_search_batch

        self._admit_free_slots()
        mask = np.array([t is not None for t in self.active])
        if not mask.any():
            return 0
        self.key, k = rng.split(self.key)
        _, stats = mcts_decode_search_batch(
            self.params, self.cfg, self.tokens, self.dcfg, k,
            prompt_lens=self.lens, request_mask=mask, device=self.device)
        self.search_stats.append(stats)
        for s, t in enumerate(self.active):
            if t is None:
                continue
            req = t.req
            tok = int(stats["best_tokens"][s])
            req.out.append(tok)
            self.tokens[s, self.lens[s]] = tok
            self.lens[s] += 1
            if (tok == self.eos_id or len(req.out) >= req.max_new
                    or self.lens[s] >= self.max_prompt_len):
                self._retire_slot(s)
        return int(mask.sum())
