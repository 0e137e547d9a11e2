"""The root-parallel forest sharded over an ensemble mesh: the port against
``repro.core.root_parallel`` (``tests/test_forest_sharding.py``'s cases).

The port's mesh is a list of devices, and a device may repeat: here every
case runs on 2, 3 or 4 virtual CPU shards (5x5 Hex), each shard with its
own storage. Every sharded port forest is held against the JAX package's
UNSHARDED ``gscpm_search_batch(shard="off")`` on the same seed, field by
field and exactly; one subprocess case holds the port's 4-shard run against
the reference's own sharded run on 4 XLA host devices. Also: the padding
math, pad-member inertness, member key streams that ignore padding,
``shard="require"`` on one entry, the launches a sync iteration (one a
shard), a forest tenant served over 2 shards (with metrics and preemption,
and under faults) equal to the batch search and the JAX engine.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_util import (FOREST_FIELDS, assert_same_serving,
                               jax_tree_fields, make_engine,
                               result_differences, serving_packages)

from repro.core import gscpm as jg
from repro.core import root_parallel as jrp
from repro.core import tree as jt
from repro_torch import convert, parity, rng
from repro_torch.core import gscpm as tg
from repro_torch.core import root_parallel as trp
from repro_torch.core import tree as tt
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh
from repro_torch.obsv import search_metrics as tsm

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 5
N_MOVES = SIZE * SIZE
STAT_KEYS = ("best_move_sum", "best_move_vote", "member_best_moves",
             "tree_nodes", "playouts", "playouts_per_tree", "rounds",
             "n_syncs", "n_trees", "member_root_values")


def kw(**over):
    base = dict(board_size=SIZE, n_playouts=96, n_tasks=8, n_workers=4,
                tree_cap=768, select_noise=1e-3)
    base.update(over)
    return base


def shards(n: int) -> list[str]:
    return ["cpu"] * n


def differing(tforest, jforest) -> list[str]:
    got, want = convert.tree_to_numpy(tforest), jax_tree_fields(jforest)
    return [k for k in want if got[k].dtype != want[k].dtype
            or not np.array_equal(got[k], want[k])]


def empty_board():
    return torch.zeros(N_MOVES, dtype=torch.int8)


def port_sharded(n: int, E: int, seed: int, **opts):
    cfg = opts.pop("cfg", tg.GSCPMConfig(**kw()))
    return trp.gscpm_search_batch(empty_board(), 1, cfg, rng.key(seed, "cpu"),
                                  n_trees=E, device=shards(n),
                                  shard="require", **opts)


def jax_unsharded(E: int, seed: int, **opts):
    cfg = opts.pop("cfg", jg.GSCPMConfig(**kw()))
    forest, st = jrp.gscpm_search_batch(
        jnp.zeros(N_MOVES, jnp.int8), 1, cfg, jax.random.key(seed),
        n_trees=E, shard="off", **opts)
    return jax_tree_fields(forest), forest, st


def assert_sharding_stats(st, n: int, E: int):
    assert st["sharded"] is True and st["n_devices"] == n
    assert st["mesh_shape"] == {"ens": n}
    assert st["padded_members"] == -E % n


# ------------------------------------------------------------- padding math ----
def test_ensemble_sharding_defaults_to_visible_devices():
    """No mesh on a host with fewer than two cards: identity."""
    sharding, padded = trp.ensemble_sharding(5, mesh=None)
    if torch.cuda.device_count() <= 1:
        assert sharding is None and padded == 5
    else:
        assert padded % torch.cuda.device_count() == 0 and padded >= 5


def test_single_device_has_no_mesh():
    if torch.cuda.device_count() <= 1:
        assert trp.ensemble_mesh() is None
    assert trp.ensemble_mesh(["cpu"]) is None
    assert trp.ensemble_mesh([]) is None
    mesh = trp.ensemble_mesh(shards(3))
    assert isinstance(mesh, Mesh) and mesh.axis_names == ("ens",)
    assert mesh.devices.shape == (3,)
    assert tuple(trp.ensemble_spec(mesh)) == ("ens",)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_ensemble_sharding_pads_to_next_device_multiple(n):
    mesh = trp.ensemble_mesh(shards(n))
    for E in range(1, 2 * n + 1):
        sharding, padded = trp.ensemble_sharding(E, mesh)
        assert sharding.mesh is mesh and tuple(sharding.spec) == ("ens",)
        assert padded % n == 0 and padded >= E
        assert padded - E < n          # NEXT multiple, not a later one


def test_pad_forest_members_appends_inert_init_trees():
    cfg = tg.GSCPMConfig(**kw())
    forest = tt.init_forest(3, cfg.tree_cap, N_MOVES, 1, "cpu")
    forest.visits[:, 0] = 4.0
    boards = empty_board()[None, :].expand(3, -1).contiguous()
    pf, pb = trp.pad_forest_members(forest, boards, 5, cfg, 1)
    assert tt.forest_size(pf) == 5 and pb.shape[0] == 5
    # pad members are freshly initialized trees: a single root, no stats
    assert pf.n_nodes[3:].tolist() == [1, 1]
    assert float(pf.visits[3:].sum()) == 0.0
    assert parity.differing_fields(
        tt.Tree(*(x[3:] for x in pf)),
        tt.init_forest(2, cfg.tree_cap, N_MOVES, 1, "cpu")) == []
    # real members are untouched
    assert torch.equal(pf.visits[:3], forest.visits)


def test_shards_own_their_storage():
    """A virtual shard is a copy, never a view into a buffer another shard
    also writes; concatenating the shards gives the forest back."""
    forest = tt.init_forest(4, 64, N_MOVES, 1, "cpu")
    forest.visits.copy_(torch.arange(forest.visits.numel(),
                                     dtype=torch.float32).view(4, -1))
    parts = tt.split_members(forest, shards(2))
    assert [tt.forest_size(p) for p in parts] == [2, 2]
    ptrs = {x.untyped_storage().data_ptr() for p in parts for x in p}
    ptrs |= {x.untyped_storage().data_ptr() for x in forest}
    assert len(ptrs) == 3 * len(tt.Tree._fields)
    parts[1].visits[0, 0] = -5.0
    assert float(forest.visits[2, 0]) != -5.0
    back = tt.concat_members(parts, "cpu")
    assert float(back.visits[2, 0]) == -5.0
    back.visits[2, 0] = forest.visits[2, 0]
    assert parity.differing_fields(back, forest) == []
    m = tsm.init_search_metrics_forest(4, "cpu")
    mparts = tt.split_members(m, shards(4))
    assert [p.lane_playouts.shape for p in mparts] == [(1,)] * 4
    assert torch.equal(tt.concat_members(mparts, "cpu").depth_sum,
                       m.depth_sum)
    with pytest.raises(ValueError, match="shards"):
        tt.split_members(forest, shards(3))


def test_mesh_entry_the_host_lacks_raises():
    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError, match="CUDA device"):
        trp.gscpm_search_batch(empty_board(), 1, tg.GSCPMConfig(**kw()),
                               rng.key(0, "cpu"), n_trees=2,
                               device=["cpu", missing])


# ---------------------------------------------------------- bit-identity ----
@pytest.fixture(scope="module")
def reference_forests():
    """The JAX package's unsharded forests, one per (E, seed, options)."""
    cache = {}

    def get(E, seed, **opts):
        k = (E, seed, repr(sorted(opts.items())))
        if k not in cache:
            ckw = kw(**opts.pop("cfg_kw", {}))
            cache[k] = jax_unsharded(E, seed, cfg=jg.GSCPMConfig(**ckw),
                                     **opts)
        return cache[k]

    return get


@pytest.mark.parametrize("n,E", [(2, 1), (2, 3), (3, 5), (4, 3), (4, 8)])
def test_sharded_batch_bit_identical_to_unsharded(n, E, reference_forests):
    """Sharding over the mesh (with padding when E % n != 0) changes
    NOTHING about the answer: the forest field by field and the stats that
    do not describe sharding equal the JAX package's one-device search."""
    fields, _, jst = reference_forests(E, 7)
    f_on, s_on = port_sharded(n, E, 7)
    assert_sharding_stats(s_on, n, E)
    assert tt.forest_size(f_on) == E            # pads sliced off
    got = convert.tree_to_numpy(f_on)
    assert [k for k in fields if not np.array_equal(got[k], fields[k])] == []
    for k in STAT_KEYS:
        assert s_on[k] == jst[k], k
    f_off, s_off = trp.gscpm_search_batch(
        empty_board(), 1, tg.GSCPMConfig(**kw()), rng.key(7, "cpu"),
        n_trees=E, device=shards(n), shard="off")
    assert s_off["sharded"] is False and s_off["n_devices"] == 1
    assert s_off["mesh_shape"] is None and s_off["padded_members"] == 0
    assert parity.differing_fields(f_on, f_off) == []
    trp.check_forest_invariants(f_on)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_periodic_sync_bit_identical(n, reference_forests):
    """``sync_root_stats`` is the ONLY cross-shard exchange; its
    delta-tracked merge stays exact when the forest lives on shards."""
    fields, jf, jst = reference_forests(3, 8, merge_every=1,
                                        cfg_kw=dict(n_playouts=128,
                                                    n_tasks=16))
    cfg = tg.GSCPMConfig(**kw(n_playouts=128, n_tasks=16))
    f_on, s_on = port_sharded(n, 3, 8, cfg=cfg, merge_every=1)
    assert_sharding_stats(s_on, n, 3)
    assert s_on["n_syncs"] == jst["n_syncs"] >= 2
    got = convert.tree_to_numpy(f_on)
    assert [k for k in fields if not np.array_equal(got[k], fields[k])] == []
    # after the final sync every member's root carries the ensemble total
    assert torch.equal(f_on.visits[:, 0],
                       torch.full((3,), float(s_on["playouts"])))
    for k in STAT_KEYS:
        assert s_on[k] == jst[k], k


@pytest.mark.parametrize("n,E", [(2, 2), (3, 2), (4, 5)])
def test_sharded_metrics_bit_identical(n, E, reference_forests):
    _, _, jst = reference_forests(E, 9, cfg_kw=dict(metrics=True))
    cfg = tg.GSCPMConfig(**kw(metrics=True))
    _, s_on = port_sharded(n, E, 9, cfg=cfg)
    assert_sharding_stats(s_on, n, E)
    assert s_on["metrics"] == jst["metrics"]


def test_shard_require_raises_on_single_device():
    cfg = tg.GSCPMConfig(**kw())
    for device in ("cpu", ["cpu"]):
        with pytest.raises(RuntimeError, match="require"):
            trp.gscpm_search_batch(empty_board(), 1, cfg, rng.key(0, "cpu"),
                                   n_trees=2, shard="require", device=device)
    if torch.cuda.device_count() <= 1:
        assert trp.ensemble_sharding(3) == (None, 3)


@pytest.mark.parametrize("n", [2, 3])
def test_launches_one_a_shard_a_sync_iteration(n, monkeypatch):
    """Each shard runs its own chunk: the descent's and the playout's
    dispatch points are reached once a shard each sync iteration (on the
    card, one launch of each kernel a shard)."""
    calls = {"select_descent": 0, "hex_playout": 0}
    for name in calls:
        inner = getattr(ops, name)

        def counted(*a, _inner=inner, _name=name, **k):
            calls[_name] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    cfg = tg.GSCPMConfig(**kw())
    _, st = port_sharded(n, 3, 1, cfg=cfg)
    iters = sum(r.m for r in tg.sched.make_schedule(
        cfg.n_playouts, cfg.n_tasks, cfg.n_workers, cfg.scheduler))
    assert calls == {"select_descent": n * iters, "hex_playout": n * iters}


# ------------------------------------------------------------------ reroot ----
@pytest.mark.parametrize("n", [2, 3])
def test_reroot_forest_round_trip_under_sharding(n):
    """Search sharded -> re-root every member -> warm-continue sharded:
    the cross-move loop, bit-identical to the JAX package's unsharded
    loop."""
    cfg_t, cfg_j = tg.GSCPMConfig(**kw()), jg.GSCPMConfig(**kw())
    forest, _ = trp.gscpm_search_batch(empty_board(), 1, cfg_t,
                                       rng.key(11, "cpu"), n_trees=2,
                                       device=shards(n), shard="require")
    mv, _ = trp.merged_root_stats(forest, N_MOVES)
    move = int(torch.argmax(mv))
    warm = tt.reroot_forest(forest, move)
    nb = empty_board()
    nb[move] = 1
    f2, s2 = trp.gscpm_search_batch(nb.expand(2, -1), 2, cfg_t,
                                    rng.key(12, "cpu"), forest=warm,
                                    device=shards(n), shard="require")
    assert s2["sharded"] and s2["reused_nodes"] > 0

    jforest, _ = jrp.gscpm_search_batch(jnp.zeros(N_MOVES, jnp.int8), 1,
                                        cfg_j, jax.random.key(11), n_trees=2,
                                        shard="off")
    jmv, _ = jrp.merged_root_stats(jforest, N_MOVES)
    assert int(jnp.argmax(jmv)) == move
    jwarm = jt.reroot_forest(jforest, move)
    jnb = jnp.zeros(N_MOVES, jnp.int8).at[move].set(1)
    jf2, js2 = jrp.gscpm_search_batch(jnp.tile(jnb[None, :], (2, 1)), 2,
                                      cfg_j, jax.random.key(12), forest=jwarm,
                                      shard="off")
    assert differing(f2, jf2) == []
    assert s2["reused_nodes"] == js2["reused_nodes"]
    assert s2["best_move_sum"] == js2["best_move_sum"]


# ------------------------------------------------------------- key streams ----
def test_member_key_streams_ignore_padding():
    """Real members' streams do not depend on how far the ensemble was
    padded: fold over arange(Ep)[:E] == fold over arange(E), and equal the
    JAX package's."""
    key = rng.key(5, "cpu")
    a = tg.fold_task_keys(key, torch.arange(3, dtype=torch.int32))
    b = tg.fold_task_keys(key, torch.arange(8, dtype=torch.int32))[:3]
    assert torch.equal(a, b)
    ja = jg.fold_task_keys(jax.random.key(5), jnp.arange(3, dtype=jnp.int32))
    np.testing.assert_array_equal(
        a.numpy().astype(np.uint32),
        np.asarray(jax.random.key_data(ja)).astype(np.uint32))


# --------------------------------------------------------------- serving ----
def engine(pkg, **kw_):
    kw_.setdefault("n_slots", 2)
    kw_.setdefault("grain", 2)
    kw_.setdefault("preempt_quanta", 2)
    return make_engine(pkg, n_workers=4, tree_cap=512, **kw_)


def forest_req(pkg, rid=0, **kw_):
    games, _ = serving_packages()[pkg]
    kw_ = {**dict(n_playouts=48, n_tasks=8, seed=3, n_trees=3), **kw_}
    return games.GameRequest(rid=rid, game="hex", board_size=SIZE, **kw_)


def serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


def test_forest_tenant_served_over_two_shards_equals_batch_search():
    eng = engine("torch", device=shards(2))
    assert eng.mesh is not None and eng.mesh.size == 2
    (r,) = serve(eng, [forest_req("torch")])
    res = r.result
    assert res["status"] == "answered"
    assert res["n_trees"] == 3 and res["playouts"] == 3 * 48
    cfg = eng.request_cfg(r)
    fst, stats = trp.gscpm_search_batch(empty_board(), 1, cfg,
                                        rng.key(3, "cpu"), n_trees=3,
                                        device="cpu")
    mv, mw = trp.merged_root_stats(fst, N_MOVES)
    np.testing.assert_array_equal(res["root_visits"], mv.numpy())
    np.testing.assert_array_equal(res["root_wins"], mw.numpy())
    assert res["best_move"] == stats["best_move_sum"]
    assert res["best_move_vote"] == stats["best_move_vote"]
    assert res["member_best_moves"] == stats["member_best_moves"]
    assert res["tree_nodes"] == sum(stats["tree_nodes"])


@pytest.mark.parametrize("pipeline", [True, False])
def test_sharded_forest_tenants_equal_jax_engine(pipeline):
    """Two forest tenants on one slot over 2 shards (3 members: one pad),
    preempted between quanta, with the device counters on: answers,
    admission, quanta and QueueStats equal the JAX engine's."""
    out = {}
    for pkg in ("jax", "torch"):
        extra = dict(device=shards(2), pipeline=pipeline) if pkg == "torch" \
            else {}
        eng = engine(pkg, n_slots=1, metrics=True, **extra)
        out[pkg] = (eng, serve(eng, [
            forest_req(pkg, rid=0, n_playouts=96, n_tasks=32),
            forest_req(pkg, rid=1, n_playouts=64, n_tasks=16, cp=0.6)]))
    (je, jr), (te, tr) = out["jax"], out["torch"]
    assert_same_serving(je, te, jr, tr)
    assert te.stats().n_preemptions > 0
    for a, b in zip(jr, tr):
        assert result_differences(a.result, b.result, FOREST_FIELDS) == []
    assert tr[0].result["metrics"]["lane_playouts"] == 3 * 96


def test_sharded_forest_tenant_under_faults_equals_jax_engine():
    """A dispatch error and a poisoned forest on a sharded tenant: the
    snapshots of the shards roll back and the answers equal the JAX
    engine's under the same plan."""
    plan = [(1, 0, "dispatch_error"), (2, 0, "poison_nan")]
    out = {}
    for pkg in ("jax", "torch"):
        _, res = serving_packages()[pkg]
        inj = res.FaultInjector(res.FaultPlan(
            events=tuple(res.FaultEvent(*e) for e in plan)))
        extra = dict(device=shards(2)) if pkg == "torch" else {}
        eng = engine(pkg, n_slots=1, grain=1, injector=inj, **extra)
        out[pkg] = (eng, serve(eng, [forest_req(pkg, n_playouts=64,
                                                n_tasks=16)]), inj)
    (je, jr, ji), (te, tr, ti) = out["jax"], out["torch"]
    assert_same_serving(je, te, jr, tr)
    assert ji.summary() == ti.summary() and ti.summary()["fired_total"] == 2
    assert tr[0].result["retries"] > 0


# ------------------------------------------- the reference's sharded run ----
REFERENCE_SHARDED = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np
from repro.core import gscpm as jg, root_parallel as jrp
cfg = jg.GSCPMConfig(**json.loads(sys.argv[1]))
forest, st = jrp.gscpm_search_batch(
    jnp.zeros(cfg.board_size ** 2, jnp.int8), 1, cfg, jax.random.key(13),
    n_trees=int(sys.argv[2]), merge_every=2, shard="require")
np.savez(sys.argv[3], **{f: np.asarray(getattr(forest, f))
                         for f in forest._fields})
keys = ("sharded", "n_devices", "mesh_shape", "padded_members", "playouts",
        "n_syncs", "tree_nodes", "member_best_moves", "best_move_sum",
        "best_move_vote")
print(json.dumps({k: st[k] for k in keys}))
"""


def test_four_shards_equal_the_reference_sharded_run(tmp_path):
    """The port on 4 virtual CPU shards against the JAX package's own
    sharded run on 4 XLA host devices (E = 5: three pad members), with
    periodic sync: forest fields and the sharding stats."""
    ckw = kw(n_playouts=128, n_tasks=16)
    out = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE_SHARDED,
                           json.dumps(ckw), "5", str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert want["sharded"] is True and want["n_devices"] == 4
    f_on, s_on = trp.gscpm_search_batch(
        empty_board(), 1, tg.GSCPMConfig(**ckw), rng.key(13, "cpu"),
        n_trees=5, merge_every=2, device=shards(4), shard="require")
    for k, v in want.items():
        assert s_on[k] == v, k
    ref = np.load(out)
    got = convert.tree_to_numpy(f_on)
    assert [k for k in ref.files
            if not np.array_equal(got[k], ref[k])] == []


def test_root_parallel_demo_takes_a_device_list(monkeypatch, capsys):
    """``--device cpu,cpu,cpu`` shards the demo's forests over three
    virtual shards; every merged answer equals the one-device run's."""
    path = os.path.join(REPO, "examples_torch", "root_parallel_demo.py")
    spec = importlib.util.spec_from_file_location("rp_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in dict(BOARD_SIZE=5, N_PLAYOUTS=32, N_WORKERS=2, N_TREES=4,
                     N_TASKS=4, TREE_CAP=256).items():
        monkeypatch.setattr(mod, k, v)

    def answers(device):
        out = mod.main(["--device", device])
        lines = capsys.readouterr().out.splitlines()
        return out, lines

    one, one_lines = answers("cpu")
    many, many_lines = answers("cpu,cpu,cpu")
    assert sum(bool(re.search(r"sharded over 3$", ln))
               for ln in many_lines) == 2
    assert not any("sharded" in ln for ln in one_lines)
    for me in (0, 2):
        assert many[me]["sharded"] and many[me]["padded_members"] == 2
        for k in ("member_best_moves", "best_move_sum", "best_move_vote",
                  "tree_nodes", "playouts"):
            assert many[me][k] == one[me][k], (me, k)
