"""The port's roofline analysis against the JAX package's: the shapes
(``configs.shapes``) and the analytic terms (``roofline.terms``) equal for
every (arch x shape) cell, ``RooflineTerms`` the same formula with the
H100's constants (``roofline.hw``), and the per-op cost count
(``roofline.op_costs``) on small ``meta`` cases whose costs are known."""

import dataclasses
import math

import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.models import api as japi
from repro.roofline import terms as jterms
from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.roofline import hw, op_costs
from repro_torch.roofline import terms as tterms
from repro_torch.roofline.op_costs import OpCosts

torch.set_num_threads(1)

CELLS = [(a, s) for a in jconfigs.ARCHS for s in jconfigs.SHAPES]


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# ------------------------------------------------------------------ shapes ----
def test_shapes_equal_the_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert ({k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()})
    assert tshapes.SUBQUADRATIC_FAMILIES == jshapes.SUBQUADRATIC_FAMILIES
    assert {k: v.tokens for k, v in tshapes.SHAPES.items()} == {
        k: v.tokens for k, v in jshapes.SHAPES.items()}
    assert tconfigs.SHAPES is tshapes.SHAPES
    assert tconfigs.tune_for_shape is tshapes.tune_for_shape


@pytest.mark.parametrize("arch,shape", CELLS)
def test_applicable_and_tune_for_shape_equal_the_reference(arch, shape):
    """Field by field, every (arch x shape) cell: whether it runs (and
    why not), and the config ``tune_for_shape`` gives it."""
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    tsh, jsh = tconfigs.SHAPES[shape], jconfigs.SHAPES[shape]
    assert tshapes.applicable(tcfg, tsh) == jshapes.applicable(jcfg, jsh)
    assert (dataclasses.asdict(tshapes.tune_for_shape(tcfg, tsh))
            == dataclasses.asdict(jshapes.tune_for_shape(jcfg, jsh)))


# ------------------------------------------------------------------- terms ----
@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_and_attention_flops_equal_the_reference(arch, shape):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    sh = jconfigs.SHAPES[shape]
    n = tapi.n_params(tcfg)
    assert n == japi.n_params(jcfg)
    assert tterms.active_params(tcfg, n) == jterms.active_params(jcfg, n)
    args = (sh.kind, sh.seq_len, sh.global_batch)
    assert (tterms.model_flops(tcfg, n, *args)
            == jterms.model_flops(jcfg, n, *args))
    assert tterms.attn_flops(tcfg, *args) == jterms.attn_flops(jcfg, *args)


def test_hw_is_the_h100():
    assert hw.BF16_TENSOR_OPS_PER_S == 989e12
    assert hw.OPS_PER_S == 67e12
    assert hw.HBM_BYTES_PER_S == 3.35e12
    assert hw.HBM_PER_CHIP == 80e9
    assert hw.NVLINK_BYTES_PER_S == 450e9


@pytest.mark.parametrize("wire", [0.0, 3e9])
def test_roofline_terms_are_the_reference_formula_with_h100_constants(
        wire, monkeypatch):
    kw = dict(flops_per_chip=2.0e15, hbm_bytes_per_chip=5.0e12,
              wire_bytes_per_chip=wire, chips=1, model_flops_global=1.5e15,
              attn_flops_global=3e14)
    t, j = tterms.RooflineTerms(**kw), jterms.RooflineTerms(**kw)
    assert t.compute_s == kw["flops_per_chip"] / 989e12
    assert t.memory_s == kw["hbm_bytes_per_chip"] / 3.35e12
    assert t.collective_s == wire / 450e9
    assert t.step_time_s == max(t.compute_s, t.memory_s, t.collective_s)
    assert t.bottleneck == "compute"
    assert t.useful_ratio == j.useful_ratio == 0.75
    assert t.mfu == pytest.approx(1.5e15 / (989e12 * t.step_time_s))
    # the same formula: given the reference's constants, the reference's
    # terms, key for key
    monkeypatch.setattr(hw, "BF16_TENSOR_OPS_PER_S", 197e12)
    monkeypatch.setattr(hw, "HBM_BYTES_PER_S", 819e9)
    monkeypatch.setattr(hw, "NVLINK_BYTES_PER_S", 50e9)
    got, want = t.to_dict(), j.to_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


# ---------------------------------------------------------------- op costs ----
def test_a_matmul_costs_exactly_2mnk():
    m, k, n = 37, 64, 19
    a, b = _meta(m, k), _meta(k, n)
    with OpCosts() as oc:
        a @ b
    c = oc.rollup()
    assert c.flops == oc.matmul_flops == 2 * m * n * k
    assert c.bytes == c.bytes_major == 4 * (m * k + k * n + m * n)
    with OpCosts() as oc:
        torch.einsum("bmk,bkn->bmn", _meta(3, m, k), _meta(3, k, n))
    assert oc.matmul_flops == 3 * 2 * m * n * k
    with OpCosts() as oc:
        torch.addmm(_meta(n), a, b)
    assert oc.flops == 2 * m * n * k + m * n     # the fused add counted


def test_views_cost_nothing_and_elementwise_costs_its_result():
    x = _meta(8, 16)
    with OpCosts() as oc:
        y = x.view(16, 8)[3:10].transpose(0, 1).unsqueeze(0).expand(2, 8, 7)
    assert oc.rollup().bytes == 0 and oc.flops == 0 and y.shape == (2, 8, 7)
    with OpCosts() as oc:
        torch.exp(x) + 1.0
    c = oc.rollup()
    assert c.flops == 2 * 128 and c.transcendentals == 128
    assert c.bytes == 2 * (4 * 128 + 4 * 128)
    assert (c.coll_wire, c.coll_count, c.coll_by_op, c.while_trips) == (
        0.0, 0.0, {}, [])


def test_cache_writes_and_gathers_count_at_slice_size():
    """An in-place write of one position into a (B, S, H, d) cache and an
    indexed one (per-row positions, ``attention.update_cache_at``) cost
    twice the slice, never the cache; a gather twice its result."""
    from repro_torch.models.attention import update_cache_at
    B, S, H, d = 4, 4096, 2, 64
    cache, new = _meta(B, S, H, d), _meta(B, 1, H, d)
    slice_bytes = 4 * B * H * d
    with OpCosts() as oc:
        update_cache_at(cache, new, 7)
    assert oc.bytes == 2 * slice_bytes
    with OpCosts() as oc:
        update_cache_at(cache, new, _meta(B, dtype=torch.int32))
    # the row index (B int64, made inside) is the only other tensor touched
    assert oc.bytes <= 2 * slice_bytes + 64 * B
    table, idx = _meta(50_000, 32), _meta(10, dtype=torch.int64)
    with OpCosts() as oc:
        torch.nn.functional.embedding(idx, table)
        table.index_select(0, idx)
    assert oc.bytes == 2 * (2 * 4 * 10 * 32)


def test_a_kernel_call_is_charged_the_kernels_own_bytes_and_operations():
    """``ops.flash_attention`` / ``ops.rmsnorm`` under a count: bytes_major
    is q + k + v + o (x + w + y), the plain body's S^2 intermediates only
    in the eager upper bound; flops are the kernel's (the causal pairs)."""
    B, S, H, Hkv, d = 2, 256, 4, 2, 64
    q = _meta(B, S, H, d, dtype=torch.bfloat16)
    k, v = (_meta(B, S, Hkv, d, dtype=torch.bfloat16) for _ in range(2))
    with OpCosts() as oc:
        o = ops.flash_attention(q, k, v, causal=True)
    c = oc.rollup()
    assert o.shape == q.shape and o.device.type == "meta"
    assert c.bytes_major == 2 * (2 * B * S * H * d + 2 * B * S * Hkv * d)
    assert c.bytes > 4 * B * H * S * S                # float32 scores
    assert c.flops == oc.matmul_flops + 4 * B * H * (S * (S + 1) // 2) * d
    assert oc.matmul_flops == 0
    assert oc.kernel_calls == {"flash_attention": 1, "rmsnorm": 0}
    x, w = _meta(3, 5, 576, dtype=torch.bfloat16), _meta(576,
                                                        dtype=torch.bfloat16)
    with OpCosts() as oc:
        ops.rmsnorm(x, w, 1e-5, order="model")
    c = oc.rollup()
    assert c.bytes_major == 2 * (2 * 15 * 576 + 576)
    assert c.flops == 4 * 15 * 576 and c.transcendentals == 15
    assert ops._costs is None                          # restored on exit


def test_a_kernel_call_under_autograd_recomputes_the_plain_version_backward():
    """As on the card (``kernels._autograd.KernelFn``): the backward is the
    plain version's, recomputed; the count sees one kernel call and one
    plain backward, and the backward's ops at their eager cost."""
    x, w = _meta(64, 128, grad=True), _meta(128, grad=True)
    with OpCosts() as oc:
        y = ops.rmsnorm(x, w, 1e-5)
        fwd_major = oc.bytes_major
        torch.autograd.grad(y.sum(), (x, w))
    assert oc.kernel_calls["rmsnorm"] == 1
    assert oc.plain_backwards == {"flash_attention": 0, "rmsnorm": 1}
    assert fwd_major == 4 * (2 * 64 * 128 + 128)
    assert oc.bytes_major > fwd_major + 4 * 64 * 128 * 3


def test_peak_tracks_the_largest_total_of_live_storages():
    """a then b live, a freed, c allocated: the peak is a + b; views and
    saved tensors keep their storage alive."""
    na, nb, nc = 1000, 3000, 500
    with OpCosts() as oc:
        a = torch.zeros(na, device="meta")
        b = torch.zeros(nb, device="meta")
        view = a[10:20]
        del a
        assert oc.live_bytes == 4 * (na + nb)          # the view holds a
        del view
        assert oc.live_bytes == 4 * nb
        c = torch.zeros(nc, device="meta")
        del b, c
    assert oc.peak_bytes == 4 * (na + nb)
    x = _meta(100, grad=True)
    with OpCosts() as oc:
        oc.track(x)
        y = x.exp()            # saved by exp's backward
        z = y.sum()
        del y
        assert oc.live_bytes == 4 * 100 + 4 * 100 + 4
        del z
        assert oc.live_bytes == 4 * 100
    assert oc.peak_bytes == 4 * 201


def test_track_and_storages_walk_nested_trees_and_modules():
    cfg = tconfigs.reduced_config("smollm-135m")
    params = tapi.abstract_params(cfg)
    lm = tapi.tfm.TransformerLM(cfg, params)
    n = sum(4 * math.prod(t.shape) for t in op_costs.leaf_tensors(params))
    assert sum(op_costs.storages({"p": lm, "x": [(_meta(3),)]}).values()) \
        == n + 12
    with OpCosts() as oc:
        oc.track({"params": lm}, (_meta(5),))
        oc.track(lm)                       # tracked once
    assert oc.peak_bytes == n + 20
