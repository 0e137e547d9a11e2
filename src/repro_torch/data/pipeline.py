"""Deterministic synthetic LM data pipeline, host-sharded, prefetching
(port of ``repro.data.pipeline``, numpy only: its batches equal the
reference's array for array).

Every batch is a pure function of (seed, step, host shard), so the loader's
full state is ONE integer — the step counter — which rides inside the
checkpoint and makes restarts exactly resumable (no data repeated, none
skipped). Each host generates only its slice of the global batch
(process_index/process_count), which is how the pipeline scales to
multi-pod: data loading is embarrassingly parallel over hosts.

The token stream is a mixture of Zipf-distributed unigrams and short copy
motifs, giving a learnable (loss goes well below uniform) yet unbounded
synthetic corpus — enough signal for the e2e train example to show a
decreasing loss curve without any external dataset.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 17
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.3
    process_index: int = 0
    process_count: int = 1

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.process_count == 0
        return self.global_batch // self.process_count


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    # Philox keyed on (seed, host) x counter=step — counter-based, O(1) seek
    # = the paper's per-task independent RNG streams, applied to the data path.
    key = (np.uint64(cfg.seed) << np.uint64(20)) | np.uint64(cfg.process_index)
    return np.random.Generator(np.random.Philox(key=[key, np.uint64(step)]))


def synth_batch(cfg: DataConfig, vocab: int, step: int,
                vlm_patches: tuple[int, int] | None = None,
                frames: tuple[int, int] | None = None) -> dict:
    """One deterministic {tokens, labels, mask} batch (+ stub modalities)."""
    rng = _rng_for(cfg, step)
    B, S = cfg.local_batch, cfg.seq_len
    # Zipf unigrams over the vocab (clipped), reserving 0 as pad/bos
    base = rng.zipf(cfg.zipf_a, size=(B, S + 1)).astype(np.int64)
    tokens = (base % (vocab - 1)) + 1
    # splice copy motifs: short windows repeated later in the sequence
    n_motifs = int(cfg.motif_prob * S / cfg.motif_len)
    L = cfg.motif_len
    if n_motifs and S + 1 > 2 * L:
        src = rng.integers(0, S + 1 - 2 * L, size=(B, n_motifs))
        dst = rng.integers(src + L, S + 2 - L)  # copy window stays in bounds
        for b in range(B):
            for m in range(n_motifs):
                s, d = src[b, m], dst[b, m]
                tokens[b, d:d + L] = tokens[b, s:s + L]
    tokens = tokens.astype(np.int32)
    out = {
        "tokens": tokens[:, :S],
        "labels": tokens[:, 1:S + 1],
        "mask": np.ones((B, S), np.float32),
    }
    if vlm_patches is not None:
        n_patches, width = vlm_patches
        out["patches"] = rng.standard_normal(
            (B, n_patches, width), dtype=np.float32) * 0.02
    if frames is not None:
        src_len, width = frames
        out["frames"] = rng.standard_normal(
            (B, src_len, width), dtype=np.float32) * 0.02
    return out


def make_batch_fn(cfg: DataConfig, model: ModelConfig,
                  src_len: int | None = None):
    """step -> batch closure, wiring the stub-modality shapes per family."""
    vlm = (model.n_patches, model.vision_width) if model.family == "vlm" else None
    frm = ((src_len or 4096, model.vision_width)
           if model.family == "encdec" else None)

    def fn(step: int) -> dict:
        # the vlm's text occupies seq_len; its patches ride alongside (the
        # prefix concat happens inside the model)
        return synth_batch(cfg, model.vocab, step, vlm_patches=vlm,
                           frames=frm)

    return fn


class Prefetcher:
    """Background-thread prefetch of the next `depth` batches.

    Overlaps host-side data generation with device compute — the data-path
    half of compute/comm overlap. ``state()``/``restore()`` expose the step
    counter for checkpointing.
    """

    def __init__(self, batch_fn, start_step: int = 0, depth: int = 2):
        self._fn = batch_fn
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self._fn(step))
            except BaseException as e:  # surface in the consumer, don't hang
                self._q.put(e)
                return
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    step += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        step, batch = item
        self._step = step + 1
        return step, batch

    def state(self) -> int:
        return self._step

    def close(self):
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()
