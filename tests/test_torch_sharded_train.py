"""Training on a mesh (``train.step.state_shardings`` / ``batch_shardings``
/ ``jit_train_step`` / ``make_train_step_compressed``, ``train.loop.train(
mesh=)``, sharded checkpoints, ``optim.compression``) against the JAX
package.

One module-scoped launch runs both sides at once
(``tests/torch_sharded_train_util.py``): 4 gloo processes of the port on
one ``FileStore``, and one JAX process on 4 host devices, both starting
from the JAX package's step-0 state written by its store. The reduced
smollm-135m twin at 2 layers, 8 x 32 tokens, ``warmup_steps=1,
total_steps=3``:

- ``train(mesh=)`` on the (2, 2) ("data", "model") mesh: the losses of the
  reference's ``train(mesh=make_host_mesh(model_axis=2))`` within rtol
  1e-4, and of the port's unsharded loop within rtol 1e-5; a run resumed
  from its step-2 checkpoint gives the straight run's loss and parameters
  exactly;
- one compressed step on (2, 2, 1) ("pod", "data", "model") against the
  reference's: the loss within rtol 1e-5, the gradient norm within rtol
  1e-4 (the int8 blocks are each rank's own block of a gradient, the
  reference's the whole gradient's: the quantization error moves the norm
  by ~1e-4 either way), the parameters after one AdamW step at eps 1e-3
  within 1e-3 of each leaf's largest magnitude;
- ``compressed_psum`` over "pod" of a (2, 2) ("pod", "data") mesh within
  the reference's bounds of the exact sum (error over scale < 0.05,
  elementwise <= n_pods x blockmax / 254), the same sum on every pod;
- checkpoints written unsharded restore sharded, and the other way, bit for
  bit.

In this process: ``quantize_int8`` / ``dequantize_int8`` bit for bit
against the JAX functions; ``state_shardings``' spec of every leaf equal
to the reference's on (2, 2) for the dense and MoE twins, and on (1, 4)
both packages refuse; the launcher's ``--mesh`` in a group of one gloo rank
prints the reference launcher's lines; ``--mesh --device cuda`` without a
card raises.
"""

from __future__ import annotations

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
from hypcompat import given, settings, st
from torch_train_util import spec_lists

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.launch import train as jlaunch
from repro.optim import compression as jcomp
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import store as tstore
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import train as tlaunch
from repro_torch.optim import compression as tcomp
from repro_torch.optim.adamw import OptConfig
from repro_torch.sharding import rules as shr
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UTIL = os.path.join(REPO, "tests", "torch_sharded_train_util.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_sharded_train_util as U  # noqa: E402

CFG = jconfigs.reduced_config(U.ARCH).replace(n_layers=U.N_LAYERS)
TCFG = tconfigs.reduced_config(U.ARCH).replace(n_layers=U.N_LAYERS)
TIMEOUT = 600


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port's rank-0 results, port params, reference results, reference
    params, the step-0 directory): the 4 gloo ranks and the JAX process
    run side by side."""
    d = tmp_path_factory.mktemp("sharded_train")
    start = str(d / "start")
    jstore.save(start, 0, jstep.make_state(CFG, jax.random.key(0)),
                extra={"data_step": 0})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    port_out, ref_out = str(d / "port" / "out.json"), str(d / "ref.json")
    os.makedirs(os.path.dirname(port_out))
    cmds = [[sys.executable, UTIL, "jax", ref_out, start]] + [
        [sys.executable, UTIL, "rank", str(r), "4", str(d / "store"),
         port_out, start] for r in range(4)]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with open(port_out) as f, open(ref_out) as g:
        port, ref = json.load(f), json.load(g)
    with np.load(port_out + ".npz") as a, np.load(ref_out + ".npz") as b:
        port_params = {k: a[k] for k in a.files}
        ref_params = {k: b[k] for k in b.files}
    return port, port_params, ref, ref_params, start


# ------------------------------------------------------------ compression ----
@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(1, 5000),
       scale=st.floats(1e-6, 1e4), block=st.sampled_from([8, 256, 1024]))
def test_quantize_is_bit_equal_to_reference(seed, n, scale, block):
    x = np.array(scale * jax.random.normal(jax.random.key(seed), (n,)),
                 np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x), block)
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x), block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tcomp.dequantize_int8(tq, ts, x.shape, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcomp.dequantize_int8(jq, js, x.shape,
                                                       jnp.float32)))


@pytest.mark.parametrize("x", [[0.0, 1.0, -1.0, 127.0, -127.0],
                               [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5],
                               [0.0] * 9],
                         ids=["extremes", "half_steps", "zeros"])
def test_quantize_edge_values_are_bit_equal_to_reference(x):
    """``tests/test_compression.py``'s edge values, ties at half a step
    (both round half to even) and an all-zero block (the divide by
    ``max(scale, 1e-30)``)."""
    x = np.asarray(x, np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x), 8)
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tcomp.dequantize_int8(tq, ts, x.shape, torch.bfloat16)
    assert back.dtype == torch.bfloat16 and back.shape == x.shape
    assert float(back[0]) == float(np.asarray(
        jcomp.dequantize_int8(jq, js, x.shape, jnp.bfloat16))[0])


def test_subnormal_block_differs_only_below_the_smallest_normal():
    """XLA's CPU backend flushes subnormal floats to zero, so a block whose
    largest magnitude is subnormal gets the scale 0 there; the port keeps
    IEEE subnormals (as the card does without ``-ftz``). The two agree to
    within the smallest normal float32."""
    x = np.asarray([3e-39, -1e-38, 0.0], np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x), 8)
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x), 8)
    assert float(np.asarray(js)[0, 0]) == 0.0 < float(ts[0, 0])
    back = tcomp.dequantize_int8(tq, ts, x.shape, torch.float32).numpy()
    want = np.asarray(jcomp.dequantize_int8(jq, js, x.shape, jnp.float32))
    assert np.abs(back - want).max() < np.finfo(np.float32).tiny


def test_compressed_psum_within_reference_bound(runs):
    psum = runs[0]["psum"]
    assert psum["err_over_scale"] < 0.05, psum
    assert psum["excess_over_bound"] <= 1e-6, psum
    assert psum["pod_peers_equal"], psum


# -------------------------------------------------------- compressed step ----
def test_compressed_step_matches_reference(runs):
    port, port_params, ref, ref_params, _ = runs
    got, want = port["compressed"], ref["compressed"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    assert got["skipped"] == want["skipped"] == 0.0
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-7)
    assert set(port_params) == set(ref_params)
    for k, w in ref_params.items():
        err = np.abs(port_params[k] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-3, (k, err)


# -------------------------------------------------------------- shardings ----
@pytest.mark.parametrize("arch", [U.ARCH, U.MOE])
def test_state_shardings_specs_match_reference(runs, arch):
    mesh = lmesh.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    got = spec_lists(tstep.state_shardings(
        mesh, tconfigs.reduced_config(arch)), shr.NamedSharding)
    assert got == runs[2]["specs_2x2"][arch]


@pytest.mark.parametrize("arch", [U.ARCH, U.MOE])
def test_state_shardings_refuse_what_does_not_divide(runs, arch):
    """On (1, 4) the twins' 2 kv heads do not divide the model axis: the
    reference's ``device_put`` raises, and the port's ``state_shardings``
    before any tensor is placed, naming the leaf and the dimension."""
    assert runs[2]["refused_1x4"][arch] is not None
    mesh = lmesh.make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)
    with pytest.raises(ValueError, match=r"attn\.wk dimension 2 of size 2"):
        tstep.state_shardings(mesh, tconfigs.reduced_config(arch))


def test_batch_shardings_split_the_leading_axis():
    mesh = lmesh.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    batch = {"tokens": np.zeros((8, 32), np.int32),
             "mask": np.zeros((5, 32), np.float32)}
    got = tstep.batch_shardings(mesh, batch)
    assert got["tokens"].spec == shr.P("data", None)
    assert got["mask"].spec == shr.P(None, None)     # 5 rows: 2 do not divide


# ------------------------------------------------------------ train(mesh=) ----
def test_train_on_mesh_matches_reference(runs):
    np.testing.assert_allclose(runs[0]["train"]["losses"],
                               runs[2]["train_losses"], rtol=1e-4)


def test_train_on_mesh_matches_unsharded_port(runs, tmp_path):
    import shutil
    ckpt = str(tmp_path / "plain")
    shutil.copytree(runs[4], ckpt)
    out = tloop.train(TCFG, OptConfig(**U.OPT), DataConfig(**U.DATA),
                      tloop.LoopConfig(steps=U.STEPS, ckpt_dir=ckpt,
                                       ckpt_every=100, log_every=1),
                      log=lambda s: None, device="cpu")
    train = runs[0]["train"]
    np.testing.assert_allclose(train["losses"],
                               [h["loss"] for h in out["history"]], rtol=1e-5)
    np.testing.assert_allclose(train["grad_norms"],
                               [h["grad_norm"] for h in out["history"]],
                               rtol=1e-5)


def test_resume_on_mesh_equals_straight_run(runs):
    train = runs[0]["train"]
    assert train["log"][0] == "[resume] restored step 0, data_step 0"
    assert train["resumed_log"][0] == (
        f"[resume] restored step {U.CKPT_EVERY}, data_step {U.CKPT_EVERY}")
    assert train["resumed_losses"] == train["losses"][U.CKPT_EVERY:]
    assert train["resumed_params_equal"]


@pytest.mark.parametrize("way", ["unsharded_to_sharded",
                                 "sharded_to_unsharded"])
def test_checkpoints_round_trip_between_layouts(runs, way):
    ck = runs[0]["checkpoints"]
    assert ck["leaves"] > 0 and ck[way], ck


# --------------------------------------------------------------- launcher ----
def _no_times(lines: list[str]) -> list[str]:
    return [re.sub(r"\d+\.\d+ steps/s|[\d.]+s\b", "<t>", ln) for ln in lines]


def test_launcher_mesh_prints_reference_lines(tmp_path, monkeypatch, capsys):
    """``--mesh --device cpu`` in a group of this process alone (gloo),
    from the JAX package's step-0 state, against the JAX launcher's
    ``--mesh`` on this process's one host device: the same lines, times
    apart; the group is torn down after."""
    import shutil
    ja, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save(ja, 0, jstep.make_state(jconfigs.reduced_config(U.ARCH),
                                        jax.random.key(1)),
                extra={"data_step": 0})
    shutil.copytree(ja, tp)
    flags = ["--steps", "3", "--seq-len", "16", "--global-batch", "4",
             "--ckpt-every", "2", "--mesh"]
    monkeypatch.setattr(sys, "argv", ["train", *flags, "--ckpt-dir", ja])
    jlaunch.main()
    want = capsys.readouterr().out.splitlines()
    tlaunch.main([*flags, "--ckpt-dir", tp, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert not torch.distributed.is_initialized()
    assert got[0] == "[resume] restored step 0, data_step 0"
    assert got[-1].startswith("final loss ")
    assert _no_times(got) == _no_times(want)
    assert tstore.latest_step(tp) == 3


def test_launcher_mesh_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--mesh", "--device", "cuda", "--steps", "1"])
    assert not torch.distributed.is_initialized()


def test_recomputation_sees_the_rules_on_another_thread():
    """A checkpointed block recomputed in the backward runs on the autograd
    engine's device thread on the card: the rules and mesh current at the
    forward must hold there too (``rules.under_current_rules``)."""
    import threading
    mesh = lmesh.make_mesh((1, 1), ("data", "model"), ["cpu"])
    rules = dict(shr.DEFAULT_RULES, act_seq=None)
    seen = {}

    def probe():
        seen["rules"], seen["mesh"] = shr.current_rules(), shr.current_mesh()

    with shr.use_rules(rules, mesh):
        bound = shr.under_current_rules(probe)
    t = threading.Thread(target=bound)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == {"rules": rules, "mesh": mesh}
    assert shr.under_current_rules(probe) is probe     # none set: fn itself
