"""zamba2 hybrid segments: ``attn_every`` Mamba-2 blocks + one SHARED dense
(attention+MLP) block, alternating between ``n_shared_blocks`` weight sets
(port of ``repro.models.hybrid``).

The shared blocks' parameters live outside the segments (every segment
reuses them: the architecture's defining trick); segment i applies shared
set ``i % n_shared_blocks`` (``_pick_shared``). Each segment keeps its
*own* attention KV cache (weights are shared, activations are not).

As in the reference (DESIGN.md §5): the shared block consumes the residual
stream directly instead of concat(x, embeddings) + re-projection, and the
per-invocation LoRA deltas on the shared weights are omitted.

The port takes a stage as a list of per-segment parameter views
(``transformer._stage_views``: each segment's ``"mamba"`` a list of
per-layer views) and the shared sets as a list of views, where the JAX
package scans stacked trees; decode writes the caches in place.
"""

from __future__ import annotations

from repro_torch.models.common import store_layer, tree_map


def _tfm():
    from repro_torch.models import transformer as tfm  # lazy: import cycle
    return tfm


def zamba_seg_specs(cfg) -> dict:
    tfm = _tfm()
    return {"mamba": tfm._stack_specs(tfm.mamba_block_specs(cfg),
                                      cfg.attn_every)}


def zamba_seg_cache_specs(cfg, batch: int, max_len: int, dtype) -> dict:
    tfm = _tfm()
    return {
        "mamba": tfm._stack_cache_specs(
            tfm.mamba_block_cache_specs(cfg, batch, max_len, dtype),
            cfg.attn_every),
        "attn": tfm.dense_block_cache_specs(cfg, batch, max_len, dtype),
    }


def _pick_shared(shared: list, i: int, n_shared: int):
    return shared[i % n_shared]


def zamba_seg_scan(segs: list, cfg, x, shared: list, maybe_remat=None):
    """The stage's forward; ``maybe_remat`` (``transformer._maybe_remat``)
    wraps each whole segment, as the reference's wraps its scan body."""
    tfm = _tfm()

    def seg_fwd(x, seg, blk):
        for lp in seg["mamba"]:
            x = tfm.mamba_block_fwd(lp, cfg, x)
        return tfm.dense_block_fwd(blk, cfg, x)

    if maybe_remat is not None:
        seg_fwd = maybe_remat(seg_fwd, cfg)
    for i, seg in enumerate(segs):
        x = seg_fwd(x, seg, _pick_shared(shared, i, cfg.n_shared_blocks))
    return x


def zamba_seg_prefill_scan(segs: list, cfg, x, shared: list, max_len: int):
    """(x, the stage's cache {"mamba": (nseg, attn_every, ...) leaves,
    "attn": (nseg, ...) leaves})."""
    tfm = _tfm()
    caches = None
    for i, seg in enumerate(segs):
        m_caches = None
        for j, lp in enumerate(seg["mamba"]):
            x, c = tfm.mamba_block_prefill(lp, cfg, x, max_len)
            m_caches = store_layer(m_caches, j, len(seg["mamba"]), c)
        blk = _pick_shared(shared, i, cfg.n_shared_blocks)
        x, a_cache = tfm.dense_block_prefill(blk, cfg, x, max_len)
        caches = store_layer(caches, i, len(segs),
                             {"mamba": m_caches, "attn": a_cache})
    return x, caches


def zamba_seg_decode_scan(segs: list, cfg, x, stage_cache, shared: list, pos):
    """One decode step through the stage; its cache is written in place."""
    tfm = _tfm()
    for i, seg in enumerate(segs):
        seg_c = tree_map(lambda t, i=i: t[i], stage_cache)
        for j, lp in enumerate(seg["mamba"]):
            lc = tree_map(lambda t, j=j: t[j], seg_c["mamba"])
            x, _ = tfm.mamba_block_decode(lp, cfg, x, lc, pos)
        blk = _pick_shared(shared, i, cfg.n_shared_blocks)
        x, _ = tfm.dense_block_decode(blk, cfg, x, seg_c["attn"], pos)
    return x, stage_cache
