"""Reducing a profiler trace to busy time, idle gaps and kernel times."""

from pytest import approx

from mctsbench.trace import label, merge, short_name, summarize


def test_names():
    n = ("void at::native::vectorized_elementwise_kernel<2, at::native::"
         "BinaryFunctor<long, long, long, at::native::(anonymous namespace)::"
         "BitwiseXorFunctor<long> >, std::array<char*, 3ul> >(int, "
         "std::array<char*, 3ul>)")
    assert short_name(n) == "vectorized_elementwise_kernel"
    assert label(n).startswith("vectorized_elementwise_kernel<2, Binary")
    assert short_name("(anonymous namespace)::select_descent_kernel(int "
                      "const*, float)") == "select_descent_kernel"
    assert short_name("hex_playout_kernel") == "hex_playout_kernel"


def test_merge():
    assert merge([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]


def test_summarize():
    dev = [("(anonymous namespace)::select_descent_kernel(int*)", 10, 20),
           ("Memcpy HtoD (Pageable -> Device)", 15, 25),
           ("hex_playout_kernel(signed char*)", 40, 50),
           ("(anonymous namespace)::select_descent_kernel(int*)", 60, 70)]
    host = [("aten::sort", 0, 9), ("aten::index", 25, 39),
            ("aten::add", 50, 100)]
    t = summarize(dev, host)
    assert t.window_s == approx(100e-6)
    assert t.busy_s == approx(35e-6)
    assert t.n_kernels == 3
    assert t.kernel_s("select_descent_kernel") == approx(20e-6)
    assert t.kernel_s("hex_playout_kernel") == approx(10e-6)
    assert t.kernel_s("missing") is None
    # idle: 70..100, 25..40, 0..10, 50..60, the longest first
    assert [round(s * 1e6) for _, s in t.idle_gaps] == [30, 15, 10, 10]
    assert t.idle_gaps[0][0] == "aten::add"
    assert t.idle_gaps[1][0] == "aten::index"
