"""The port's data pipeline (``repro_torch.data.pipeline``, numpy only)
against the JAX package's: batches equal array for array for the dense,
vlm and encdec families at several steps and seeds, with host sharding;
the reference's own checks (determinism, shifted labels, the prefetcher's
resume and error) on the port."""

import dataclasses

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe


@pytest.mark.parametrize("arch", ["smollm-135m", "paligemma-3b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("seed,steps", [(17, (0, 1, 7)), (3, (2, 40))])
def test_batches_equal_reference(arch, seed, steps):
    jcfg, tcfg = jconfigs.reduced_config(arch), tconfigs.reduced_config(arch)
    for process_index in (0, 1):
        kw = dict(seq_len=40, global_batch=4, seed=seed,
                  process_index=process_index, process_count=2)
        jfn = jpipe.make_batch_fn(jpipe.DataConfig(**kw), jcfg, src_len=24)
        tfn = tpipe.make_batch_fn(tpipe.DataConfig(**kw), tcfg, src_len=24)
        for step in steps:
            want, got = jfn(step), tfn(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_data_config_matches_reference():
    assert [f.name for f in dataclasses.fields(tpipe.DataConfig)] == [
        f.name for f in dataclasses.fields(jpipe.DataConfig)]
    assert tpipe.DataConfig(8, 4).local_batch == 4
    assert tpipe.DataConfig(8, 4, process_count=2).local_batch == 2


def test_deterministic_per_step_and_labels_shifted():
    dc = tpipe.DataConfig(seq_len=64, global_batch=4, seed=9)
    a, b = tpipe.synth_batch(dc, 512, 3), tpipe.synth_batch(dc, 512, 3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert (a["tokens"] != tpipe.synth_batch(dc, 512, 4)["tokens"]).any()
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert (a["tokens"] >= 1).all() and (a["tokens"] < 512).all()


def test_prefetcher_resumes_at_start_step():
    dc = tpipe.DataConfig(seq_len=16, global_batch=2, seed=3)
    fn = tpipe.make_batch_fn(dc, tconfigs.reduced_config("smollm-135m"))
    p1 = tpipe.Prefetcher(fn, start_step=0)
    seen = [next(p1) for _ in range(3)]
    state = p1.state()
    p1.close()
    assert [s for s, _ in seen] == [0, 1, 2] and state == 3
    p2 = tpipe.Prefetcher(fn, start_step=state)
    s, batch = next(p2)
    p2.close()
    assert s == 3
    np.testing.assert_array_equal(batch["tokens"], fn(3)["tokens"])


def test_prefetcher_reraises_a_workers_error():
    def bad(step):
        raise RuntimeError("boom")
    p = tpipe.Prefetcher(bad, start_step=0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            next(p)
    finally:
        p.close()
