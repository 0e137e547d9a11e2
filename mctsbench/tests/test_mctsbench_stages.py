"""Putting a profiled call's device operations down to the program's stage
ranges: by the launch's host time, not by overlap on the device."""

import torch
from pytest import approx

from mctsbench import stages
from mctsbench.trace import summarize

# host: keys 0..10, descent 10..20, propose 20..30; a runtime call outside
# every range at 40; the device runs behind the host
RANGES = [("keys", 0, 10), ("descent", 10, 20), ("propose", 20, 30)]
LAUNCHES = {1: 1.0, 2: 5.0, 3: 12.0, 4: 25.0, 5: 40.0}
OPS = [("threefry_kernel(long*)", 2, 4, 1),
       ("threefry_kernel(long*)", 6, 8, 2),
       ("select_descent_kernel(int*)", 15, 32, 3),
       ("Memcpy HtoD (Pageable -> Device)", 30, 35, 4),
       ("hex_playout_kernel(signed char*)", 50, 60, 5),
       ("orphan_kernel()", 61, 62, 99)]
CALLS = [("cudaLaunchKernel", 1.0), ("cudaStreamSynchronize", 3.0),
         ("cudaMemcpyAsync", 25.0), ("cudaDeviceSynchronize", 45.0),
         ("cudaLaunchKernel", 12.0)]


def reduced():
    return stages.reduce(RANGES, LAUNCHES, OPS, CALLS)


def test_an_operation_counts_to_the_range_that_launched_it():
    st = reduced().stages
    # launched at 12 inside descent, run 15..32, after descent closed at 20
    assert st["descent"].device_s == approx(17e-6)
    assert st["descent"].launches == 1
    # the copy overlaps the descent kernel on the device: only its own 2 us
    assert st["propose"].device_s == approx(3e-6)
    assert st["propose"].launches == 0            # copies are no kernels
    assert st["keys"].launches == 2
    # no range open at its launch, or no launch in the trace
    assert st[stages.UNSTAGED].launches == 2
    assert st[stages.UNSTAGED].device_s == approx(11e-6)


def test_blocking_calls_count_to_their_stage():
    st = reduced()
    assert st.stages["keys"].waits == 1
    assert st.stages[stages.UNSTAGED].waits == 1
    assert sum(s.waits for s in st.stages.values()) == 2
    assert st.wait_calls == {"cudaStreamSynchronize": 1,
                             "cudaDeviceSynchronize": 1}


def test_idle_gaps_go_to_the_stage_whose_operation_ends_them():
    st = reduced()
    s = st.stages
    assert s["keys"].idle_s == approx(4e-6)       # 0..2 and 4..6
    assert s["descent"].idle_s == approx(7e-6)    # 8..15
    assert s["propose"].idle_s == 0
    assert s[stages.UNSTAGED].idle_s == approx(16e-6)   # 35..50, 60..61
    assert st.tail_idle_s == 0
    assert [s[k].host_s for k in ("keys", "descent", "propose")] == \
        [approx(10e-6)] * 3


def test_stages_and_the_unstaged_rest_add_up_to_the_busy_time():
    st = reduced()
    busy = summarize([o[:3] for o in OPS], [("gscpm.keys", 0, 10)]).busy_s
    assert st.busy_s == approx(busy)
    assert sum(s.device_s for s in st.stages.values()) == approx(busy)
    n_kernels = summarize([o[:3] for o in OPS], []).n_kernels
    assert sum(s.launches for s in st.stages.values()) == n_kernels


def test_a_range_inside_another_counts_once():
    st = stages.reduce([("keys", 0, 10), ("descent", 2, 4)], {1: 3.0},
                       [("k", 5, 6, 1)], [])
    assert list(st.stages) == ["keys"]
    assert st.stages["keys"].device_s == approx(1e-6)
    assert st.tail_idle_s == approx(4e-6)         # 6..10


def test_profiled_search_on_the_cpu_has_its_stage_ranges():
    from repro_torch import rng
    from repro_torch.core import gscpm, root_parallel
    cfg = gscpm.GSCPMConfig(board_size=5, n_workers=4, n_tasks=8,
                            n_playouts=16, tree_cap=256)
    key = rng.key(1, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        root_parallel.gscpm_search_batch(
            torch.zeros(25, dtype=torch.int8), 1, cfg, key, n_trees=2,
            device="cpu")
    st = stages.from_profiler(prof)
    assert list(st.stages) == ["init", "round_inputs", "keys", "descent",
                               "propose", "expand", "playout", "backup",
                               "summary"]
    assert st.busy_s == 0 and all(s.host_s > 0 for s in st.stages.values())
    lines = stages.table(st, 4)
    assert lines[0].split() == ["stage", "device", "ms", "launches",
                                "waits", "idle", "ms", "host", "ms"]
    assert len(lines) == len(st.stages) + 2
    assert set(stages.as_dict(st)["stages"]["keys"]) == {
        "device_s", "launches", "waits", "idle_s", "host_s"}
