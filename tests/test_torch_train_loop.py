"""The port's training loop and its entry points against the JAX
package's, on the CPU, from ONE state: the JAX package's ``make_state``
written by its store at step 0, the directory copied, so that both loops
resume from it (each restoring the other's format). Five steps of
``train`` give the reference's losses (rtol 1e-4) and parameters (within
the gradient tolerance, at ``tests/test_train.py``'s schedule; see
``test_torch_train_step.py`` for why the schedule); the port's final
checkpoint restores in the JAX package; a restart resumes exactly
(``tests/test_train.py::test_resume_equivalence``); the launcher and the
example print the reference's lines apart from times. On a mesh of one
gloo rank ``train(mesh=)`` follows the reference's on its one host device,
and the launcher's ``--mesh`` resumes; on 4 ranks in
``test_torch_sharded_train.py``."""

import dataclasses
import importlib.util
import pathlib
import re
import shutil
import sys

import jax
import numpy as np
import torch
from torch_train_util import (TOL, assert_trees_close, flat_jax, flat_port,
                              one_rank_mesh)

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.data.pipeline import DataConfig as JDataConfig
from repro.launch import train as jlaunch
from repro.launch.mesh import make_host_mesh
from repro.optim.adamw import OptConfig as JOptConfig
from repro.train import loop as jloop
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.checkpoint import store as tstore
from repro_torch.data.pipeline import DataConfig as TDataConfig
from repro_torch.launch import train as tlaunch
from repro_torch.models.common import tree_leaves
from repro_torch.optim.adamw import OptConfig as TOptConfig
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = jconfigs.reduced_config("smollm-135m").replace(n_layers=2)
TCFG = convert.model_config_from_dict(dataclasses.asdict(CFG))
OC = dict(lr=1e-3, warmup_steps=4, total_steps=40)
DC = dict(seq_len=32, global_batch=8, seed=5)


def _shared_start(tmp_path, cfg=CFG, seed=11) -> tuple[str, str]:
    """Two copies of a directory holding the JAX package's step-0 state."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save(a, 0, jstep.make_state(cfg, jax.random.key(seed)),
                extra={"data_step": 0})
    shutil.copytree(a, b)
    return a, b


def _load(package: str, name: str):
    path = ROOT / package / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{package}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _times_out(lines: list[str]) -> list[str]:
    """The lines with their wall times (and steps/s) removed."""
    return [re.sub(r"\d+\.\d+ steps/s|[\d.]+s\b", "<t>", ln) for ln in lines]


def test_five_steps_match_reference_from_one_state(tmp_path):
    ja, tp_dir = _shared_start(tmp_path)
    jlog, tlog = [], []
    loop = dict(steps=5, ckpt_every=100, log_every=1, n_microbatches=2)
    jout = jloop.train(CFG, JOptConfig(**OC), JDataConfig(**DC),
                       jloop.LoopConfig(ckpt_dir=ja, **loop), log=jlog.append)
    want_params = flat_jax(jout["state"]["params"])      # read at once
    tout = tloop.train(TCFG, TOptConfig(**OC), TDataConfig(**DC),
                       tloop.LoopConfig(ckpt_dir=tp_dir, **loop),
                       log=tlog.append, device="cpu")
    assert [h["step"] for h in tout["history"]] == list(range(5))
    assert set(tout["history"][0]) == set(jout["history"][0])
    assert set(tout) == set(jout)
    np.testing.assert_allclose([h["loss"] for h in tout["history"]],
                               [h["loss"] for h in jout["history"]],
                               rtol=1e-4)
    assert [h["lr"] for h in tout["history"]] == [
        h["lr"] for h in jout["history"]]
    assert all(h["skipped"] == 0.0 for h in tout["history"])
    assert_trees_close(flat_port(tout["state"]["params"]), want_params, TOL,
                       "final params")
    assert tlog[0] == jlog[0] == "[resume] restored step 0, data_step 0"
    assert _times_out(tlog) == _times_out(jlog)
    # the port's final checkpoint (step 5) restores in the JAX package
    assert jstore.latest_step(tp_dir) == 5
    back, extra = jstore.restore(tp_dir, 5, jstep.abstract_state(CFG))
    assert extra == {"data_step": 5} and int(back["opt"]["step"]) == 5
    assert_trees_close(flat_jax(back["params"]),
                       flat_port(tout["state"]["params"]), 0.0, "restored")


def test_resume_equivalence(tmp_path):
    """5 steps + restart + 5 steps == 10 straight steps, loss for loss."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    run = lambda d, n: tloop.train(
        TCFG, TOptConfig(**OC), TDataConfig(**DC),
        tloop.LoopConfig(steps=n, ckpt_dir=d, ckpt_every=5, log_every=100),
        log=lambda s: None, device="cpu")
    straight = run(d1, 10)
    run(d2, 5)
    resumed = run(d2, 10)
    assert resumed["history"][0]["step"] == 5
    assert [h["loss"] for h in resumed["history"]] == [
        h["loss"] for h in straight["history"][5:]]
    assert_trees_close(flat_port(resumed["state"]["params"]),
                       flat_port(straight["state"]["params"]), 0.0, "resume")


def test_nonfinite_step_is_skipped_and_logged(tmp_path, monkeypatch):
    """A poisoned batch: the update is skipped, logged, and the run goes
    on with the next batch."""
    from repro_torch.data import pipeline as tpipe
    real = tpipe.make_batch_fn

    def poisoned(dc, cfg, src_len=None):
        fn = real(dc, cfg, src_len)

        def batch(step):
            b = fn(step)
            if step == 1:
                b["mask"] = np.full_like(b["mask"], np.nan)
            return b
        return batch

    monkeypatch.setattr(tloop, "make_batch_fn", poisoned)
    log = []
    out = tloop.train(TCFG, TOptConfig(**OC), TDataConfig(**DC),
                      tloop.LoopConfig(steps=3, log_every=100), log=log.append,
                      device="cpu")
    assert [h["skipped"] for h in out["history"]] == [0.0, 1.0, 0.0]
    assert "[skip] step 1: non-finite grads, update skipped" in log
    assert np.isfinite(out["history"][2]["loss"])


def test_launcher_prints_the_reference_lines(tmp_path, monkeypatch, capsys):
    """``repro_torch.launch.train --device cpu`` and ``repro.launch.train``
    from one step-0 state: the same lines, times apart."""
    ja, tp_dir = _shared_start(tmp_path, jconfigs.reduced_config(
        "smollm-135m"), seed=0)
    flags = ["--steps", "4", "--seq-len", "16", "--global-batch", "4",
             "--microbatches", "2", "--ckpt-every", "100"]
    monkeypatch.setattr(sys, "argv", ["train", *flags, "--ckpt-dir", ja])
    jlaunch.main()
    want = capsys.readouterr().out.splitlines()
    out = tlaunch.main([*flags, "--ckpt-dir", tp_dir, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert _times_out(got) == _times_out(want)
    assert got[0] == "[resume] restored step 0, data_step 0"
    assert got[-1].startswith("final loss ") and out["stragglers"] == 0


def test_example_prints_the_reference_lines(tmp_path, monkeypatch, capsys):
    """``examples_torch/train_lm.py --device cpu`` and
    ``examples/train_lm.py`` (its small twin) from one step-0 state."""
    jex, tex = (_load(package, "train_lm")
                for package in ("examples", "examples_torch"))
    cfg = jconfigs.reduced_config("smollm-135m").replace(**tex.SMALL)
    ja, tp_dir = _shared_start(tmp_path, cfg, seed=0)
    monkeypatch.setattr(sys, "argv", ["train_lm", "--steps", "3",
                                      "--ckpt-dir", ja])
    jex.main()
    want = capsys.readouterr().out.splitlines()
    tex.main(["--steps", "3", "--ckpt-dir", tp_dir, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert _times_out(got) == _times_out(
        [ln.replace(ja, tp_dir) for ln in want])


def test_formerly_refused_train_on_mesh_matches_reference(tmp_path):
    """``train(mesh=)`` on a 1 x 1 mesh of one gloo rank and the
    reference's ``train(mesh=make_host_mesh())`` on its one host device,
    from one step-0 state: five steps' losses within rtol 1e-4, the
    parameters within the gradient tolerance, the final checkpoint written
    (by rank 0) and restorable unsharded."""
    ja, tp_dir = _shared_start(tmp_path)
    loop = dict(steps=5, ckpt_every=100, log_every=1, n_microbatches=2)
    jout = jloop.train(CFG, JOptConfig(**OC), JDataConfig(**DC),
                       jloop.LoopConfig(ckpt_dir=ja, **loop),
                       mesh=make_host_mesh(), log=lambda s: None)
    want_params = flat_jax(jout["state"]["params"])
    with one_rank_mesh(("data", "model")) as mesh:
        tout = tloop.train(TCFG, TOptConfig(**OC), TDataConfig(**DC),
                           tloop.LoopConfig(ckpt_dir=tp_dir, **loop),
                           mesh=mesh, log=lambda s: None, device="cpu")
        got = {k: v.detach().full_tensor().numpy() for k, v in
               tree_leaves(tout["state"]["params"].tree())}
    np.testing.assert_allclose([h["loss"] for h in tout["history"]],
                               [h["loss"] for h in jout["history"]],
                               rtol=1e-4)
    assert_trees_close(got, want_params, TOL, "params")
    back, extra = tstore.restore(tp_dir, 5, tstep.abstract_state(TCFG),
                                 device="cpu")
    assert extra == {"data_step": 5}
    assert_trees_close(flat_port(back["params"]), got, 0.0, "restored")


def test_formerly_refused_launch_mesh_resumes(tmp_path, capsys):
    """``--mesh --device cpu`` in a group of this process alone: 3 steps,
    then a relaunch to 5 resumes from the step-3 checkpoint, and its
    losses equal the unsharded launcher's over 5 steps from the same
    start (rtol 1e-5); each launch tears its group down."""
    ja, tp_dir = _shared_start(tmp_path, jconfigs.reduced_config(
        "smollm-135m"), seed=0)
    flags = ["--seq-len", "16", "--global-batch", "4", "--ckpt-every", "3",
             "--device", "cpu"]
    first = tlaunch.main(["--steps", "3", "--mesh", "--ckpt-dir", tp_dir,
                          *flags])
    assert not torch.distributed.is_initialized()
    capsys.readouterr()
    second = tlaunch.main(["--steps", "5", "--mesh", "--ckpt-dir", tp_dir,
                           *flags])
    assert capsys.readouterr().out.splitlines()[0] == (
        "[resume] restored step 3, data_step 3")
    plain = tlaunch.main(["--steps", "5", "--ckpt-dir", ja, *flags])
    np.testing.assert_allclose(
        [h["loss"] for h in first["history"] + second["history"]],
        [h["loss"] for h in plain["history"]], rtol=1e-5)
