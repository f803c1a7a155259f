"""The span readers (``perfbench/metrics/*_span_*.py``) on a synthetic
window whose spans carry the program's device times (``args.dev_ts``,
``args.dev_dur``, µs): per-step sums, the backward's self time and the
step's coverage by device-interval containment across threads, and None
where the spans are missing (a program without them, or the CPU)."""

import pytest

from perfbench.core import device_trace, registry

MAIN, AUTOGRAD = 1, 2

SPAN_READERS = ("feed_span_ms", "embedding_fwd_span_ms",
                "embedding_bwd_span_ms", "fm_span_ms", "tower_fwd_span_ms",
                "backward_self_span_ms", "optimizer_span_ms",
                "step_span_coverage_pct")


def span(name, dev_ts, dev_dur, tid=MAIN, host_ts=None):
    """A host span with device times; its host interval is elsewhere."""
    return {"name": name, "ph": "X",
            "ts": 5e9 if host_ts is None else host_ts, "dur": 1.0,
            "pid": 7, "tid": tid,
            "args": {"dev_ts": float(dev_ts), "dev_dur": float(dev_dur)}}


def step_spans(t):
    """One step's spans from µs ``t``: 1,000 µs of step, of which 900 in
    layer spans; the backward's children on autograd's thread."""
    return [span("train.step", t, 1000),
            span("embed.fwd", t + 10, 50),
            span("fm.fwd", t + 60, 20),
            span("tower.fwd", t + 80, 100),
            span("train.loss", t + 180, 30),
            span("train.backward", t + 210, 600),
            span("embed.bwd", t + 220, 400, AUTOGRAD),
            span("fm.bwd", t + 630, 40, AUTOGRAD),
            span("embed.bwd", t + 680, 20, AUTOGRAD),
            span("train.optimizer", t + 910, 90)]


def window(spans, steps):
    return device_trace.Context(
        ops=[], spans=spans, t0=0, t1=10**9, steps=steps,
        examples_per_s=1.0, cards=1, shapes={}, peaks={},
        kernel=registry.kernel)


def two_dispatches():
    """Two dispatches of two steps, each fed by one ``train.feed``."""
    spans = []
    for d in range(2):
        base = 1e6 + d * 10_000
        spans.append(span("train.feed", base, 200))
        spans += step_spans(base + 300) + step_spans(base + 1400)
    return spans


def read(name, ctx):
    return registry.metric(name).read(ctx)


@pytest.mark.parametrize("name,want", [
    ("feed_span_ms", 2 * 0.2 / 4),
    ("embedding_fwd_span_ms", 0.05),
    ("embedding_bwd_span_ms", 0.42),
    ("fm_span_ms", 0.06),
    ("tower_fwd_span_ms", 0.1),
    ("backward_self_span_ms", (600 - 460) / 1e3),
    ("optimizer_span_ms", 0.09),
    ("step_span_coverage_pct", 100.0 * (50 + 20 + 100 + 30 + 600 + 90)
     / 1000),
])
def test_reader_on_a_synthetic_window(name, want):
    assert read(name, window(two_dispatches(), 4)) == pytest.approx(want)


def test_children_count_by_device_interval_not_by_thread():
    """An autograd-thread child inside the backward's device interval is
    subtracted; one outside it (an eval's, say) is not."""
    spans = [span("train.step", 0, 1000),
             span("train.backward", 100, 500),
             span("embed.bwd", 150, 300, AUTOGRAD, host_ts=1.0),
             span("embed.bwd", 700, 100, AUTOGRAD)]
    assert read("backward_self_span_ms", window(spans, 1)) == \
        pytest.approx(0.2)


def test_overlapping_children_count_once():
    spans = [span("train.backward", 0, 1000),
             span("embed.bwd", 100, 400, AUTOGRAD),
             span("fm.bwd", 300, 400, AUTOGRAD)]
    assert read("backward_self_span_ms", window(spans, 1)) == \
        pytest.approx(0.4)


def test_coverage_counts_only_layers_inside_a_step():
    """A forward outside any step (an evaluation) adds nothing; a layer
    span a rounding's µs past its step's end still counts."""
    spans = [span("train.step", 0, 1000),
             span("embed.fwd", 100, 400),
             span("train.optimizer", 600, 400.5),
             span("embed.fwd", 5000, 400)]
    assert read("step_span_coverage_pct", window(spans, 1)) == \
        pytest.approx(100.0 * 800.5 / 1000)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_none_without_the_spans(name):
    """Host spans alone (the CPU, or a program without device spans) and
    no spans at all both read None."""
    host_only = [{**s, "args": {}} for s in two_dispatches()]
    assert read(name, window(host_only, 4)) is None
    assert read(name, window([], 4)) is None


@pytest.mark.parametrize("name", SPAN_READERS[:-1])
def test_per_step_readers_read_none_without_steps(name):
    assert read(name, window(two_dispatches(), 0)) is None


@pytest.mark.parametrize("name,missing", [
    ("backward_self_span_ms", ("train.backward",)),
    ("step_span_coverage_pct", ("train.step",)),
    ("fm_span_ms", ("fm.fwd", "fm.bwd")),
])
def test_none_when_the_read_span_is_missing(name, missing):
    spans = [s for s in two_dispatches() if s["name"] not in missing]
    assert read(name, window(spans, 4)) is None
