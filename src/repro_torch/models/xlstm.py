"""xLSTM blocks: mLSTM (matrix memory, parallel form) + sLSTM (scalar
memory) (port of ``repro.models.xlstm``; arXiv:2405.04517).

mLSTM runs prefill in the stabilized parallel (quadratic) form, or chunkwise
(``_mlstm_chunked``) when the sequence is longer than ``cfg.mlstm_chunk``
and a multiple of it, and decodes with the O(1) recurrence. sLSTM is
sequential (recurrent gate mixing): a Python loop over the tokens in both
modes, where the JAX package runs ``lax.scan``.

Gating: the forget gate through logsigmoid, the input gate exponential with
the max-stabilizer m (float32). Every cast is where the reference casts.
Decode steps write the new state into the cache they are given (in place),
where the JAX package returns a new cache.

Sharded (DTensor activations inside an LM mesh) the sLSTM token loop is a
region on each rank's rows and heads (``_slstm_loop_sharded``): DTensor has
no strategy for the logsigmoid's backward, and the recurrence needs its
heads whole. The loop is a ``kernels.ops.token_loop``, which a roofline
count on ``meta`` charges as one token step times its trips.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, Spec, dense_spec, norm_spec
from repro_torch.models.layers import rmsnorm
from repro_torch.models.ssm import _causal_conv, conv_step
from repro_torch.sharding import rules as shr

QKV_BLOCK = 4  # official xLSTM qkv_proj_blocksize (near-diagonal projections)
CONV_K = 4


def mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    d_in = int(cfg.mlstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    dv = d_in // H
    dk = dv
    return d_in, H, dk, dv


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


# ------------------------------------------------------------------ mLSTM ----
def mlstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, H, dk, dv = mlstm_dims(cfg)
    K = CONV_K
    blk = (d_in // QKV_BLOCK, QKV_BLOCK, QKV_BLOCK)
    return {
        "ln": norm_spec(d),
        "w_up": dense_spec(d, d_in, ("embed", "mlp")),
        "w_gate": dense_spec(d, d_in, ("embed", "mlp")),
        "w_conv": Spec((K, d_in), ("conv", None), 1.0 / math.sqrt(K)),
        "b_conv": Spec((d_in,), (None,), 0.0),
        # blocksize-4 head-wise projections (the official xLSTM's
        # LinearHeadwiseExpand with qkv_proj_blocksize=4)
        "w_q": Spec(blk, ("mlp", None, None), 1.0 / math.sqrt(QKV_BLOCK)),
        "w_k": Spec(blk, ("mlp", None, None), 1.0 / math.sqrt(QKV_BLOCK)),
        "w_v": Spec(blk, ("mlp", None, None), 1.0 / math.sqrt(QKV_BLOCK)),
        "w_i": dense_spec(d_in, H, ("mlp", "heads")),
        "w_f": dense_spec(d_in, H, ("mlp", "heads")),
        "b_i": Spec((H,), ("heads",), 0.0),
        "b_f": Spec((H,), ("heads",), 0.0),
        "out_norm": norm_spec(d_in),
        "w_down": dense_spec(d_in, d, ("mlp", "embed")),
    }


def _headwise(x: torch.Tensor, w: torch.Tensor, H: int) -> torch.Tensor:
    """einsum("...nd,nde->...ne") over the (nb, 4) blocks of the last axis,
    reshaped to (..., H, d_in / H)."""
    *lead, d_in = x.shape
    nb = d_in // QKV_BLOCK
    xb = x.reshape(-1, nb, QKV_BLOCK).transpose(0, 1)       # (nb, N, 4)
    y = torch.bmm(xb, w.to(x.dtype)).transpose(0, 1)        # (N, nb, 4)
    if isinstance(y, DTensor):          # split the heads only as they divide
        y = shr.heads_splittable(y.reshape(*lead, d_in), H)
    return y.reshape(*lead, H, d_in // H)


def _mlstm_gates(params, c: torch.Tensor):
    """float32 input and forget pre-activations of the conv stream."""
    dt = c.dtype
    i_t = (c @ params["w_i"].to(dt)).to(torch.float32) + params["b_i"]
    f_t = (c @ params["w_f"].to(dt)).to(torch.float32) + params["b_f"]
    return i_t, f_t


def _mlstm_qkv(params, cfg: ModelConfig, x: torch.Tensor):
    dt = x.dtype
    H = cfg.n_heads
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    u = h @ params["w_up"].to(dt)
    gate = h @ params["w_gate"].to(dt)
    c = F.silu(_causal_conv(u, params["w_conv"], params["b_conv"]))
    q = _headwise(c, params["w_q"], H)
    k = _headwise(c, params["w_k"], H)
    v = _headwise(u, params["w_v"], H)
    i_t, f_t = _mlstm_gates(params, c)
    return u, gate, q, k, v, i_t, f_t


def _mlstm_out(params, cfg: ModelConfig, hout: torch.Tensor,
               gate: torch.Tensor) -> torch.Tensor:
    hout = rmsnorm(hout, params["out_norm"], cfg.norm_eps)
    return (hout * F.silu(gate)) @ params["w_down"].to(hout.dtype)


def _conv_tail(u: torch.Tensor) -> torch.Tensor:
    """The conv window a decode step continues from: the last 3 rows (zeros
    when the sequence is shorter)."""
    B, L, d = u.shape
    if L >= CONV_K - 1:
        return u[:, L - (CONV_K - 1):, :]
    return torch.zeros((B, CONV_K - 1, d), dtype=u.dtype, device=u.device)


def _use_chunked(cfg: ModelConfig, L: int) -> bool:
    return bool(cfg.mlstm_chunk) and L > cfg.mlstm_chunk \
        and L % cfg.mlstm_chunk == 0


def _mlstm_chunked(params, cfg: ModelConfig, x: torch.Tensor):
    """Chunkwise-parallel stabilized mLSTM, scan-free: the intra-chunk
    quadratic form within Q, per-chunk local states, and the cross-chunk
    state passing as a strictly lower-triangular (nc x nc) product with the
    stabilizer carried in log space. Returns (y, decode cache {C, n, m,
    conv})."""
    B, L, d = x.shape
    d_in, H, dk, dv = mlstm_dims(cfg)
    Q = cfg.mlstm_chunk
    nc = L // Q
    dt = x.dtype
    dev = x.device
    inf = float("inf")
    u, gate, q, k, v, i_t, f_t = _mlstm_qkv(params, cfg, x)
    # the chunks reshape the sequence: whole on every rank when sharded
    q, k, v, i_t, f_t = (shr.whole_dims(t, (1,)) for t in (q, k, v, i_t, f_t))
    k = k / math.sqrt(dk)

    qc = q.reshape(B, nc, Q, H, dk)
    kc = k.reshape(B, nc, Q, H, dk)
    vc = v.reshape(B, nc, Q, H, dv)
    logf = F.logsigmoid(f_t).reshape(B, nc, Q, H)          # f32
    ic = i_t.reshape(B, nc, Q, H)
    Floc = torch.cumsum(logf, dim=2)                       # (B,nc,Q,H)

    # ---- intra-chunk (quadratic within Q) -------------------------------
    Dlog = (Floc[:, :, :, None, :] - Floc[:, :, None, :, :]
            + ic[:, :, None, :, :])                        # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    Dlog = torch.where(tri[None, None, :, :, None], Dlog, -inf)
    m_intra = torch.amax(Dlog, dim=3)                      # (B,nc,Q,H)

    # ---- per-chunk local states -----------------------------------------
    w = Floc[:, :, -1:, :] - Floc + ic                     # (B,nc,Q,H)
    m_loc = torch.amax(w, dim=2)                           # (B,nc,H)
    g = torch.exp(w - m_loc[:, :, None, :]).to(dt)
    gk = g[..., None] * kc                                 # (B,nc,Q,H,dk)
    S_loc = torch.einsum("bcjhk,bcjhv->bchkv", gk, vc)
    n_loc = gk.sum(dim=2)

    # ---- cross-chunk state passing (triangular product, stabilized) -----
    G = torch.cumsum(Floc[:, :, -1, :], dim=1)             # (B,nc,H)
    Gprev = F.pad(G[:, :-1], (0, 0, 1, 0))
    A = (Gprev[:, :, None, :] - G[:, None, :, :]
         + m_loc[:, None, :, :])                           # (B,nc,nc,H)
    ctri = torch.tril(torch.ones((nc, nc), dtype=torch.bool, device=dev), -1)
    A = torch.where(ctri[None, :, :, None], A, -inf)
    Tmax = torch.amax(A, dim=2)                            # (B,nc,H); -inf @ c=0
    finite = torch.isfinite(Tmax)
    Tmax_safe = torch.where(finite, Tmax, 0.0)
    Aw = torch.where(ctri[None, :, :, None],
                     torch.exp(torch.clamp(A - Tmax_safe[:, :, None, :],
                                           -60.0, 0.0)),
                     0.0).to(dt)
    S_tilde = torch.einsum("bcCh,bChkv->bchkv", Aw, S_loc)  # (B,nc,H,dk,dv)
    n_tilde = torch.einsum("bcCh,bChk->bchk", Aw, n_loc)

    # ---- combine intra + inter with a joint row stabilizer ---------------
    inter_log = torch.where(finite[:, :, None, :],
                            Floc + Tmax_safe[:, :, None, :], -inf)
    M = torch.maximum(inter_log, m_intra)                  # (B,nc,Q,H) finite
    P = torch.where(tri[None, None, :, :, None],
                    torch.exp(Dlog - M[:, :, :, None, :]), 0.0).to(dt)
    scores = torch.einsum("bcihk,bcjhk->bcijh", qc, kc)
    sp = scores * P
    num_intra = torch.einsum("bcijh,bcjhv->bcihv", sp, vc)
    den_intra = sp.sum(dim=3)
    sc = torch.where(torch.isfinite(inter_log),
                     torch.exp(inter_log - M), 0.0).to(dt)  # (B,nc,Q,H)
    num_inter = torch.einsum("bcihk,bchkv->bcihv", qc, S_tilde) * sc[..., None]
    den_inter = torch.einsum("bcihk,bchk->bcih", qc, n_tilde) * sc
    num = num_intra + num_inter
    den = den_intra + den_inter
    hout = num / torch.maximum(den.abs(), torch.exp(-M).to(dt))[..., None]

    y = _mlstm_out(params, cfg, hout.reshape(B, L, d_in), gate)

    # ---- end state (decode cache) ----------------------------------------
    wf = G[:, -1:, :] - G + m_loc                          # (B,nc,H)
    m_end = torch.amax(wf, dim=1)                          # (B,H) f32
    gf = torch.exp(wf - m_end[:, None, :]).to(dt)
    C_end = torch.einsum("bch,bchkv->bhkv", gf, S_loc)
    n_end = torch.einsum("bch,bchk->bhk", gf, n_loc)
    cache = {"C": C_end, "n": n_end, "m": m_end, "conv": _conv_tail(u)}
    return y, cache


def _mlstm_quadratic(cfg: ModelConfig, q, k, v, i_t, f_t, dt):
    """The parallel stabilized form: hout (B,L,H,dv)."""
    B, L, H, dk = q.shape
    logf = F.logsigmoid(f_t)                               # (B,L,H)
    Fc = torch.cumsum(logf, dim=1)
    # D_log[i,j] = F_i - F_j + itilde_j  (j <= i)
    D_log = (Fc[:, :, None, :] - Fc[:, None, :, :]) + i_t[:, None, :, :]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    D_log = torch.where(tri[None, :, :, None], D_log, -float("inf"))
    m = torch.amax(D_log, dim=2)                           # (B,L,H)
    Dm = torch.exp(D_log - m[:, :, None, :])
    scores = torch.einsum("blhk,bmhk->blmh", q, k) / math.sqrt(dk)
    S = scores * Dm.to(dt)
    norm = torch.maximum(S.sum(dim=2).abs(), torch.exp(-m).to(dt))  # (B,L,H)
    return torch.einsum("blmh,bmhv->blhv", S, v) / norm[..., None]


def mlstm_forward(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Parallel (quadratic) stabilized mLSTM. x: (B,L,d)."""
    B, L, d = x.shape
    if _use_chunked(cfg, L):
        return _mlstm_chunked(params, cfg, x)[0]
    d_in = mlstm_dims(cfg)[0]
    u, gate, q, k, v, i_t, f_t = _mlstm_qkv(params, cfg, x)
    hout = _mlstm_quadratic(cfg, q, k, v, i_t, f_t, x.dtype)
    return _mlstm_out(params, cfg, hout.reshape(B, L, d_in), gate)


def mlstm_prefill(params, cfg: ModelConfig, x: torch.Tensor):
    """Parallel forward + the recurrent (C, n, m) state after the last
    token, and the conv window."""
    B, L, d = x.shape
    if _use_chunked(cfg, L):
        return _mlstm_chunked(params, cfg, x)
    d_in, H, dk, dv = mlstm_dims(cfg)
    u, gate, q, k, v, i_t, f_t = _mlstm_qkv(params, cfg, x)
    hout = _mlstm_quadratic(cfg, q, k, v, i_t, f_t, x.dtype)
    y = _mlstm_out(params, cfg, hout.reshape(B, L, d_in), gate)

    logf = F.logsigmoid(f_t)                               # (B,L,H)
    Fc = torch.cumsum(logf, dim=1)
    # state weight of token j at the end: F_L - F_j + i_j
    w = Fc[:, -1:, :] - Fc + i_t                           # (B,L,H)
    m_end = torch.amax(w, dim=1)                           # (B,H)
    g = torch.exp(w - m_end[:, None, :]).to(x.dtype)       # (B,L,H)
    gk = g[..., None] * (k / math.sqrt(dk))                # (B,L,H,dk)
    C = torch.einsum("blhk,blhv->bhkv", gk, v)
    n = gk.sum(dim=1)
    return y, {"C": C, "n": n, "m": m_end, "conv": _conv_tail(u)}


def mlstm_cache_specs(cfg: ModelConfig, batch: int, dtype) -> dict:
    d_in, H, dk, dv = mlstm_dims(cfg)
    return {
        "C": ((batch, H, dk, dv), dtype, ("batch", "heads", None, None)),
        "n": ((batch, H, dk), dtype, ("batch", "heads", None)),
        "m": ((batch, H), torch.float32, ("batch", "heads")),
        "conv": ((batch, CONV_K - 1, d_in), dtype, ("batch", None, None)),
    }


def mlstm_init_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    """The JAX package's ``mlstm_init_cache``: m = -inf (a zero cache, as
    ``lm_init_cache`` makes, is an equivalent start)."""
    cache = {name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt, _) in mlstm_cache_specs(cfg, batch, dtype).items()}
    cache["m"].fill_(-float("inf"))
    return cache


def mlstm_decode(params, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """O(1) recurrent step. x: (B,1,d); the cache is written IN PLACE and
    returned."""
    B = x.shape[0]
    d_in, H, dk, dv = mlstm_dims(cfg)
    dt = x.dtype
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    u = h @ params["w_up"].to(dt)
    gate = h @ params["w_gate"].to(dt)
    window = torch.cat([cache["conv"], u.to(cache["conv"].dtype)], dim=1)
    c = F.silu(conv_step(window, params["w_conv"], params["b_conv"], dt))
    q = _headwise(c, params["w_q"], H)                     # (B,H,dk)
    k = _headwise(c, params["w_k"], H)
    v = _headwise(u[:, 0], params["w_v"], H)
    i_t, f_t = _mlstm_gates(params, c)

    logf = F.logsigmoid(f_t)                               # (B,H)
    m_prev = cache["m"]
    m_new = torch.maximum(logf + m_prev, i_t)
    i_p = torch.exp(i_t - m_new).to(dt)
    f_p = torch.exp(logf + m_prev - m_new).to(dt)
    k_s = k / math.sqrt(dk)
    C = f_p[..., None, None] * cache["C"].to(dt) + \
        i_p[..., None, None] * (k_s[..., :, None] * v[..., None, :])
    n = f_p[..., None] * cache["n"].to(dt) + i_p[..., None] * k_s
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs(),
                        torch.exp(-m_new).to(dt))
    hout = (num / den[..., None]).reshape(B, 1, d_in)
    y = _mlstm_out(params, cfg, hout, gate)
    cache["C"].copy_(C)
    cache["n"].copy_(n)
    cache["m"].copy_(m_new)
    cache["conv"].copy_(window[:, 1:])
    return y, cache


# ------------------------------------------------------------------ sLSTM ----
GATES = ("i", "f", "z", "o")


def slstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    ffd = int(d * 4 / 3)
    K = CONV_K
    s = {"ln": norm_spec(d),
         "w_conv": Spec((K, d), ("conv", None), 1.0 / math.sqrt(K)),
         "b_conv": Spec((d,), (None,), 0.0),
         "out_norm": norm_spec(d),
         "w_up1": dense_spec(d, ffd, ("embed", "mlp")),
         "w_up2": dense_spec(d, ffd, ("embed", "mlp")),
         "w_down": dense_spec(ffd, d, ("mlp", "embed"))}
    for g in GATES:
        s[f"w_{g}"] = dense_spec(d, d, ("embed", "heads"))
        s[f"r_{g}"] = Spec((H, dh, dh), ("heads", None, None), 1.0 / math.sqrt(dh))
        s[f"b_{g}"] = Spec((d,), (None,), 0.0)
    return s


def _slstm_cell(params, gates_x: dict, state: tuple, H: int, dh: int):
    """One sLSTM step. gates_x: precomputed W·x (B,d) per gate; state (h,
    c, n, m), h/c/n (B,H,dh) in the activations' dtype, m float32;
    ``params[f"r_{g}"]`` the recurrent weights (H, dh, dh)."""
    h, c, n, m = state
    hh = h.transpose(0, 1)                                 # (H,B,dh)

    def rec(g):
        r = torch.bmm(hh, params[f"r_{g}"].to(h.dtype)).transpose(0, 1)
        gx = gates_x[g]
        if isinstance(gx, DTensor):     # (decode) split only as heads divide
            gx = shr.heads_splittable(gx, H)
        return gx.reshape(-1, H, dh) + r

    i_t = rec("i").to(torch.float32)
    f_t = rec("f").to(torch.float32)
    z_t = torch.tanh(rec("z"))
    o_t = torch.sigmoid(rec("o"))
    logf = F.logsigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    i_p = torch.exp(i_t - m_new).to(h.dtype)
    f_p = torch.exp(logf + m - m_new).to(h.dtype)
    c_new = f_p * c + i_p * z_t
    n_new = f_p * n + i_p
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new)


def _slstm_gates_x(params, cpre, hin, dt):
    return {g: (cpre if g in ("i", "f") else hin) @ params[f"w_{g}"].to(dt)
            + params[f"b_{g}"].to(dt) for g in GATES}


def _slstm_ffn(params, cfg: ModelConfig, hout: torch.Tensor) -> torch.Tensor:
    dt = hout.dtype
    hout = rmsnorm(hout, params["out_norm"], cfg.norm_eps)
    y = (hout @ params["w_up1"].to(dt)) * _gelu(hout @ params["w_up2"].to(dt))
    return y @ params["w_down"].to(dt)


def _slstm_scan(params, cfg: ModelConfig, x: torch.Tensor):
    """The token loop: (per-token h (B,L,d), final state, normed input).
    On DTensors the loop runs on each rank's rows and heads
    (``_slstm_loop_sharded``)."""
    B, L, d = x.shape
    H = cfg.n_heads
    dh = d // H
    dt = x.dtype
    hin = rmsnorm(x, params["ln"], cfg.norm_eps)
    cpre = F.silu(_causal_conv(hin, params["w_conv"], params["b_conv"]))
    gx = _slstm_gates_x(params, cpre, hin, dt)
    r = {f"r_{g}": params[f"r_{g}"] for g in GATES}
    if isinstance(x, DTensor):
        hs, st = _slstm_loop_sharded(r, gx, H, dh)
    else:
        hs, st = _slstm_loop(r, gx, H, dh)
    return hs, st, hin


def _slstm_loop(r: dict, gx: dict, H: int, dh: int):
    """(h of every token (B, L, H*dh), final state) of the recurrence over
    the gates' input parts ``gx`` (B, L, H*dh) and the recurrent weights
    ``r`` (H, dh, dh), a ``kernels.ops.token_loop``."""
    B, L, _ = gx["i"].shape
    dt = gx["i"].dtype
    zeros = torch.zeros((B, H, dh), dtype=dt, device=gx["i"].device)
    st = (zeros, zeros, zeros,
          torch.full((B, H, dh), -1e30, dtype=torch.float32,
                     device=gx["i"].device))

    def step(t, st):
        st = _slstm_cell(r, {g: gx[g][:, t] for g in GATES}, st, H, dh)
        return st[0], st

    hs, st = ops.token_loop(step, L, st, (r, gx))
    return hs.reshape(B, L, H * dh), st


def _slstm_loop_sharded(r: dict, gx: dict, H: int, dh: int):
    """``_slstm_loop`` on one rank: its rows, and its heads when the heads
    divide the model axis (the recurrence mixes within a head only, so a
    head is never split); the state leaves split alike."""
    B, L, d = gx["i"].shape
    split = shr.spec_for(shr.current_mesh(), ("heads", None, None),
                         (H, dh, dh))[0] is not None
    hax = "heads" if split else None
    g_ax, r_ax, s_ax = ("batch", None, hax), (hax, None, None), (
        "batch", hax, None)

    def local(*xs):
        rl = {f"r_{g}": x for g, x in zip(GATES, xs[:4])}
        gl = dict(zip(GATES, xs[4:]))
        hs, st = _slstm_loop(rl, gl, xs[0].shape[0], dh)
        return (hs, *st)

    outs = shr.local_region(
        local, [*(r[f"r_{g}"] for g in GATES), *(gx[g] for g in GATES)],
        [r_ax] * 4 + [g_ax] * 4,
        [(g_ax, (B, L, d))] + [(s_ax, (B, H, dh))] * 4)
    return outs[0], tuple(outs[1:])


def slstm_forward(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return _slstm_ffn(params, cfg, _slstm_scan(params, cfg, x)[0])


def slstm_prefill(params, cfg: ModelConfig, x: torch.Tensor):
    """The sequential scan that also returns the final state."""
    hout, (h_f, c_f, n_f, m_f), hin = _slstm_scan(params, cfg, x)
    y = _slstm_ffn(params, cfg, hout)
    return y, {"h": h_f, "c": c_f, "n": n_f, "m": m_f,
               "conv": _conv_tail(hin)}


def slstm_cache_specs(cfg: ModelConfig, batch: int, dtype) -> dict:
    H = cfg.n_heads
    dh = cfg.d_model // H
    return {"h": ((batch, H, dh), dtype, ("batch", "heads", None)),
            "c": ((batch, H, dh), dtype, ("batch", "heads", None)),
            "n": ((batch, H, dh), dtype, ("batch", "heads", None)),
            "m": ((batch, H, dh), torch.float32, ("batch", "heads", None)),
            "conv": ((batch, CONV_K - 1, cfg.d_model), dtype,
                     ("batch", None, None))}


def slstm_init_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    cache = {name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt, _) in slstm_cache_specs(cfg, batch, dtype).items()}
    cache["m"].fill_(-1e30)
    return cache


def slstm_decode(params, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """One recurrent step. x: (B,1,d); the cache is written IN PLACE and
    returned."""
    B = x.shape[0]
    H = cfg.n_heads
    d = cfg.d_model
    dh = d // H
    dt = x.dtype
    hin = rmsnorm(x, params["ln"], cfg.norm_eps)           # (B,1,d)
    window = torch.cat([cache["conv"], hin.to(cache["conv"].dtype)], dim=1)
    cpre = F.silu(conv_step(window, params["w_conv"], params["b_conv"], dt))
    gx = _slstm_gates_x(params, cpre, hin[:, 0], dt)
    st = (cache["h"].to(dt), cache["c"].to(dt), cache["n"].to(dt), cache["m"])
    h_new, c_new, n_new, m_new = _slstm_cell(params, gx, st, H, dh)
    y = _slstm_ffn(params, cfg, h_new.reshape(B, 1, d))
    for name, t in (("h", h_new), ("c", c_new), ("n", n_new), ("m", m_new),
                    ("conv", window[:, 1:])):
        cache[name].copy_(t)
    return y, cache
