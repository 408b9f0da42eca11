"""The span readers' arithmetic (benchmark/spans.py) on a synthetic trace
and synthetic span records: the newest records, as many as the trace has
host ranges of the span, summed over the traced steps; None where the
span is missing, where no record has a device time, and on a program
that keeps no spans."""

import collections
import types

import pytest

from benchmark import run
from benchmark.devtrace import Trace
from benchmark.spans import per_step_ms


class _Event:
    """A CUDA event's stand-in: a time in ms on the device's clock."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _record(name, device_ms=None):
    ev = (None, None) if device_ms is None else (_Event(0.0),
                                                 _Event(device_ms))
    return (name, 0, 1000, *ev)


@pytest.fixture
def records(monkeypatch):
    """The program's span registry, emptied for the test."""
    from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
    spans = collections.deque(maxlen=profiling.SPAN_RECORDS)
    monkeypatch.setattr(profiling, "_SPANS", spans)
    return spans


def _ctx(host, steps):
    trace = Trace(1e-3, [("k", 0.0, 10.0)], host, 0.0, 1000.0)
    return types.SimpleNamespace(
        trace=trace, driver=types.SimpleNamespace(trace_work={"steps": steps}))


def test_newest_records_over_the_steps(records):
    # two warm-up records (outside the trace's window), then three of the
    # window, with another span between
    records.extend([_record("ad.forward", 100.0), _record("ad.forward", 90.0),
                    _record("ad.forward", 20.0), _record("ad.update", 1.0),
                    _record("ad.forward", 21.0), _record("ad.forward", 22.0)])
    host = [("ad.forward", 0.0, 1.0), ("aten::mm", 0.2, 0.8),
            ("ad.forward", 2.0, 3.0), ("ad.update", 3.0, 4.0),
            ("ad.forward", 4.0, 5.0)]
    assert per_step_ms(_ctx(host, 3), "ad.forward") == pytest.approx(
        (20.0 + 21.0 + 22.0) / 3)
    assert per_step_ms(_ctx(host, 2), "ad.update") == pytest.approx(0.5)


def test_none_where_the_span_is_missing(records):
    records.append(_record("ad.draw", 1.0))
    assert per_step_ms(_ctx([("aten::mm", 0.0, 1.0)], 1), "ad.draw") is None
    assert per_step_ms(_ctx([("ad.draw", 0.0, 1.0)], 1), "ad.forward") \
        is None


def test_none_without_a_device_time(records):
    records.extend([_record("diff.steps"), _record("diff.steps")])
    assert per_step_ms(_ctx([("diff.steps", 0.0, 1.0)] * 2, 200),
                       "diff.steps") is None


def test_none_on_a_program_without_spans(monkeypatch):
    from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
    monkeypatch.delattr(profiling, "span_records")
    assert per_step_ms(_ctx([("ad.draw", 0.0, 1.0)], 1), "ad.draw") is None


@pytest.mark.parametrize("metric,span", [
    ("ad.draw_ms", "ad.draw"), ("ad.forward_ms", "ad.forward"),
    ("ad.backward_ms", "ad.backward"), ("ad.update_ms", "ad.update"),
    ("diff.steps_ms", "diff.steps")])
def test_each_reader_reads_its_span(records, metric, span):
    records.extend([_record(span, 3.0), _record(span, 5.0)])
    ctx = _ctx([(span, 0.0, 1.0), (span, 1.0, 2.0)], 4)
    assert run.metric_reader(metric)(ctx) == pytest.approx(2.0)
