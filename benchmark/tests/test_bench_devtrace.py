"""The trace reader's arithmetic on synthetic events: the union of device
spans, top operations, and idle gaps named by the host op around them."""

import pytest

from benchmark.devtrace import Trace


def _trace():
    kernels = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 40.0, 50.0),
               ("k3", 90.0, 100.0)]
    host = [("step", 0.0, 100.0), ("aten::mm", 22.0, 38.0),
            ("sync", 55.0, 95.0)]
    return Trace(100e-6, kernels, host, 0.0, 100.0)


def test_busy_is_the_union_of_spans():
    t = _trace()
    assert t.busy_us() == pytest.approx(20 + 10 + 10)
    assert t.device_s(lambda n: n == "k1") == pytest.approx(20e-6)
    assert t.count(lambda n: n.startswith("k")) == 4


def test_top_ops_by_time():
    assert _trace().top_ops(2) == [["k1", pytest.approx(20e-6)],
                                   ["k2", pytest.approx(15e-6)]]


def test_idle_gaps_named_by_the_innermost_host_op():
    gaps = dict((n, v) for n, v in _trace().idle_gaps())
    assert gaps["aten::mm"] == pytest.approx(20e-6)     # 20 .. 40
    assert gaps["sync"] == pytest.approx(40e-6)         # 50 .. 90
    assert sum(gaps.values()) == pytest.approx(60e-6)
