"""The benchmark's arithmetic on synthetic inputs: rooflines, the idle
share, the trace's attribution and the checksums."""
from types import SimpleNamespace

import pytest

from portbench.lib import arith
from portbench.lib.trace import Trace


def test_roofline_and_idle():
    card = "NVIDIA H100 80GB HBM3"
    assert arith.roofline_pct(3.35e9, 1e-3, card) == pytest.approx(100.0)
    assert arith.roofline_pct(3.35e9, 4e-3, card) == pytest.approx(25.0)
    assert arith.roofline_pct(0, 1.0, card) is None
    assert arith.roofline_pct(10, 0.0, card) is None
    assert arith.idle_pct(0.25, 1.0) == pytest.approx(75.0)
    with pytest.raises(KeyError):
        arith.peaks("some other card")


class _Ev:
    def __init__(self, name, dev, start, dur, tid=1, corr=0, stream=7):
        self._n, self._d, self._s, self._u = name, dev, start, dur
        self._t, self._c, self._r = tid, corr, stream

    def name(self): return self._n
    def device_type(self): return self._d
    def start_ns(self): return self._s
    def duration_ns(self): return self._u
    def start_thread_id(self): return self._t
    def linked_correlation_id(self): return self._c
    def device_resource_id(self): return self._r


def _trace(more=()):
    from torch.autograd import DeviceType

    C, G = DeviceType.CPU, DeviceType.CUDA
    ev = [*more,_Ev("pb.window", C, 0, 1000),
          _Ev("pb.study", C, 100, 400), _Ev("pb.plan_body", C, 150, 300),
          _Ev("pb.node.lookup_join", C, 160, 100),
          _Ev("aten::index", C, 170, 10, corr=7),
          _Ev("cudaLaunchKernel", C, 175, 3, corr=7),
          _Ev("pb.node.compact", C, 300, 100),
          _Ev("aten::nonzero", C, 310, 10, corr=8),
          _Ev("join_kernel", G, 200, 100, corr=7),
          _Ev("compact_kernel", G, 250, 150, corr=8),
          _Ev("memcpy", G, 900, 50, corr=9),
          # the library's kernel: no host launch recorded; its call in
          # pb.node.fused_mask lies between its neighbours' launches
          _Ev("pb.node.fused_mask", C, 520, 30),
          _Ev("pb.launch.repro_predicate_bitset", C, 525, 5),
          _Ev("predicate_kernel(PredArgs)", G, 600, 20),
          _Ev("aten::copy_", C, 560, 10, corr=9)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    return Trace(prof)


def test_trace_attribution_busy_and_host():
    t = _trace()
    assert t.window_s() == pytest.approx(1e-6)
    # kernels 200-300 and 250-400 overlap; 600-620; the copy 900-950
    assert t.busy_s() == pytest.approx(270e-9)
    assert t.device_s_by("pb.node.fused_mask") == pytest.approx(20e-9)
    assert t.device_s_by("pb.node.lookup_join") == pytest.approx(100e-9)
    assert t.device_s_by("pb.node.compact") == pytest.approx(150e-9)
    assert t.device_s_by("pb.node.") == pytest.approx(270e-9)
    assert t.library_kernels == 1
    # pb.study 100-500 less pb.plan_body 150-450
    assert t.host_outside("pb.study", "pb.plan_body") == [pytest.approx(100e-9)]
    b = t.breakdown()
    assert b["device_ops"][0][0].startswith("pb.node.compact")
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(730e-9)


def test_library_kernels_pair_with_their_calls_or_fail():
    from torch.autograd import DeviceType

    C, G = DeviceType.CPU, DeviceType.CUDA
    # two calls in two node ranges with no launch between them: paired
    # one to one, in order
    t = _trace([_Ev("pb.node.slice_time", C, 700, 20),
                _Ev("pb.launch.repro_compact_scatter", C, 705, 5),
                _Ev("pb.node.compact", C, 730, 20),
                _Ev("pb.launch.repro_compact_scatter", C, 735, 5),
                _Ev("compact_scatter_kernel", G, 960, 10),
                _Ev("compact_scatter_kernel", G, 975, 10)])
    assert t.device_s_by("pb.node.slice_time") == pytest.approx(10e-9)
    assert t.device_s_by("pb.node.compact") == pytest.approx(160e-9)
    # another stream's copy, launched after the call, starts before the
    # library's kernel: only the kernel's own stream bounds its call
    t = _trace([_Ev("pb.node.slice_time", C, 700, 20),
                _Ev("pb.launch.repro_compact_scatter", C, 705, 5),
                _Ev("cudaMemcpyAsync", C, 740, 5, corr=12),
                _Ev("memcpy", G, 955, 3, corr=12, stream=9),
                _Ev("compact_scatter_kernel", G, 960, 10)])
    assert t.device_s_by("pb.node.slice_time") == pytest.approx(10e-9)
    # a kernel with no host launch and no library call in its span: the
    # node range open at both ends of the span, here none
    t = _trace([_Ev("new_kernel", G, 980, 5)])
    assert t.owner[-1] is None and t.library_kernels == 1
    assert t.placed["by the range open at both ends"] == 1
    assert "new_kernel" in t.summary()
    # ... and where one node range is open across the whole span, that one
    # (the copy launched at 560 is the dedupe's too)
    t = _trace([_Ev("pb.node.dedupe", C, 555, 435),
                _Ev("new_kernel", G, 980, 5)])
    assert t.device_s_by("pb.node.dedupe") == pytest.approx(55e-9)
    # three kernels against two calls in two ranges (one call launches two
    # kernels): each name pairs in order with the calls
    t = _trace([_Ev("pb.node.slice_time", C, 700, 20),
                _Ev("pb.launch.repro_mask_compact", C, 705, 5),
                _Ev("pb.node.compact", C, 730, 20),
                _Ev("pb.launch.repro_mask_compact", C, 735, 5),
                _Ev("mask_compact_kernel", G, 960, 5),
                _Ev("fill_tail_kernel", G, 970, 5),
                _Ev("mask_compact_kernel", G, 980, 5)])
    assert t.device_s_by("pb.node.slice_time") == pytest.approx(5e-9)
    assert t.device_s_by("pb.node.compact") == pytest.approx(160e-9)
    assert t.placed["in order"] == 3
    # a call that launches nothing: the plain span before teaches which
    # entry launches compact_scatter_kernel, and its calls pair one to one
    t = _trace([_Ev("pb.launch.repro_compact_scatter", C, 180, 5),
                _Ev("compact_scatter_kernel", G, 240, 5),
                _Ev("pb.node.slice_time", C, 700, 20),
                _Ev("pb.launch.repro_compact_scatter", C, 705, 5),
                _Ev("pb.node.compact", C, 730, 30),
                _Ev("pb.launch.repro_predicate_occupancy", C, 735, 5),
                _Ev("pb.launch.repro_compact_scatter", C, 745, 5),
                _Ev("compact_scatter_kernel", G, 960, 10),
                _Ev("compact_scatter_kernel", G, 975, 10)])
    assert t.device_s_by("pb.node.lookup_join") == pytest.approx(105e-9)
    assert t.device_s_by("pb.node.slice_time") == pytest.approx(10e-9)
    assert t.device_s_by("pb.node.compact") == pytest.approx(160e-9)
    assert t.library_kernels == 4


def test_checksums_find_one_changed_value_and_a_swap():
    import torch

    from portbench.lib import compare

    x = torch.zeros(300, 36, 128)
    x[17, 3, 5] = 2.0
    a = compare._features_digest({"X": x})
    assert compare.features_differing(
        {"features": a, "feature_checks": {}},
        {"features": compare._features_digest({"X": x.clone()}),
         "feature_checks": {}}) == 0
    for change in ((299, 35, 127, 1.0), (17, 3, 6, 2.0)):
        y = x.clone()
        y[change[:3]] = change[3]
        if change[2] == 6:
            y[17, 3, 5] = 0.0                 # the same sum, moved
        b = compare._features_digest({"X": y})
        assert compare.features_differing(
            {"features": a, "feature_checks": {}},
            {"features": b, "feature_checks": {}}) == 1


def test_table_checksums_in_order_and_as_sets():
    import torch

    from portbench.lib import compare

    t = {"a": torch.arange(10, dtype=torch.int32),
         "w": torch.linspace(0, 1, 10)}
    swapped = {k: v[[1, 0, *range(2, 10)]] for k, v in t.items()}
    d, s = compare.rows_digest(t), compare.rows_digest(swapped)
    assert compare.tables_differing(d, s, ordered=True) == 2   # 2 columns
    assert compare.tables_differing(d, s, ordered=False) == 0
    changed = dict(t, a=t["a"].clone())
    changed["a"][9] = 11
    c = compare.rows_digest(changed)
    assert compare.tables_differing(d, c, ordered=False) == 1
    assert compare.tables_differing(d, compare.rows_digest(t, count=9)) == 0
    assert compare.tables_differing(compare.rows_digest(t, count=9), d) == 1
