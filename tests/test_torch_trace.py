"""The port's span tracer (``obs/trace.py``) and its device time.

On the CPU: a span off is the shared null span and records no event; a
span on the CPU is a host span without ``dev_*`` fields; the device path
against a fake CUDA event (the anchor, ``dev_ts``/``dev_dur``, a span
opened while a graph is captured, the reference moving up over a long
run, the ``ring`` cap on unresolved pairs); the layer spans of a tiny
DeepFM's ``fit_device_resident``, counted per step and per dispatch; and
``fit``'s dispatch timer on the host clock. On the card (marked ``card``,
skipped without one): the tracer's clock against the profiler's. Run the
card test from the repository's root with
``python -m pytest --noconftest tests/test_torch_trace.py -s``.
"""

import json
import time

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data.cache import CacheColumns
from deepfm_tpu_torch.obs import trace as trace_lib
from deepfm_tpu_torch.train import Trainer
from deepfm_tpu_torch.train import loop as loop_lib

torch.set_num_threads(1)

#: The layer spans of one dense DeepFM step and their count a step.
STEP_SPANS = {"train.step": 1, "embed.fwd": 1, "fm.fwd": 1, "tower.fwd": 1,
              "train.loss": 1, "train.backward": 1, "embed.bwd": 2,
              "fm.bwd": 1, "train.optimizer": 1}


@pytest.fixture(autouse=True)
def _tracer_off():
    trace_lib.reset()
    yield
    trace_lib.reset()


def _x_events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]


# -- a fake card --------------------------------------------------------------

class FakeClock:
    """The card's clock in ms, moved by hand."""

    def __init__(self):
        self.ms = 0.0


class FakeEvent:
    """``torch.cuda.Event`` on a fake clock: stamped at ``record``,
    complete once ``done`` (``synchronize`` completes it)."""

    made = 0

    def __init__(self, clock, done):
        FakeEvent.made += 1
        self._clock, self.done, self.t = clock, done, None

    def record(self):
        self.t = self._clock.ms

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda's events, sync and capture query on a fake clock; the
    events complete when made unless ``card.done`` is False."""
    card = FakeClock()
    card.done = True
    card.capturing = False

    def event(enable_timing=False):
        assert enable_timing
        return FakeEvent(card, card.done)

    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: card.capturing)
    FakeEvent.made = 0
    return card


CARD = torch.device("cuda")


# -- off, and on the CPU ------------------------------------------------------

def test_off_returns_the_null_span_and_makes_no_event(fake_card):
    assert not trace_lib.enabled()
    sp = trace_lib.span("embed.fwd", device=CARD)
    assert sp is trace_lib._NULL
    assert trace_lib.span("train.step", device=CARD, steps=8) is sp
    with sp as inner:
        assert inner is sp
    assert FakeEvent.made == 0
    assert trace_lib.export() is None


@pytest.mark.parametrize("device", [torch.device("cpu"), "cpu", None])
def test_a_cpu_span_is_a_host_span(tmp_path, fake_card, device):
    trace_lib.configure("full", export_env=False)
    with trace_lib.span("plain", device=device):
        with trace_lib.span("attrs", device=device, rows=3):
            pass
    events = {e["name"]: e for e in _x_events(
        trace_lib.export(str(tmp_path / "t.json")))}
    assert "args" not in events["plain"]
    assert events["attrs"]["args"] == {"rows": 3}
    assert FakeEvent.made == 0


# -- the device path, on a fake card ------------------------------------------

def test_device_span_gains_device_time_on_the_wall_clock(tmp_path, fake_card):
    trace_lib.configure("full", export_env=False)
    before = time.time_ns() / 1e3
    with trace_lib.span("outer", device=CARD, steps=2):
        fake_card.ms += 2.0
        with trace_lib.span("inner", device=CARD):
            fake_card.ms += 3.5
        fake_card.ms += 1.0
    after = time.time_ns() / 1e3
    ev = {e["name"]: e for e in _x_events(
        trace_lib.export(str(tmp_path / "t.json")))}
    # the anchor's, outer's start, inner's pair, outer's end
    assert FakeEvent.made == trace_lib.ANCHOR_TRIES + 4
    outer, inner = ev["outer"]["args"], ev["inner"]["args"]
    assert outer["steps"] == 2
    assert outer["dev_dur"] == pytest.approx(6500.0)
    assert inner["dev_dur"] == pytest.approx(3500.0)
    assert inner["dev_ts"] - outer["dev_ts"] == pytest.approx(2000.0)
    # The anchor maps the card's time 0 into [before, after] of the host.
    assert before <= outer["dev_ts"] <= after


def test_a_span_opened_while_capturing_is_a_host_span(tmp_path, fake_card):
    trace_lib.configure("full", export_env=False)
    fake_card.capturing = True
    with trace_lib.span("captured", device=CARD):
        pass
    assert FakeEvent.made == 0
    fake_card.capturing = False
    with trace_lib.span("timed", device=CARD):
        pass
    ev = {e["name"]: e for e in _x_events(
        trace_lib.export(str(tmp_path / "t.json")))}
    assert "args" not in ev["captured"]
    assert set(ev["timed"]["args"]) == {"dev_ts", "dev_dur"}


def test_pairs_resolve_once_complete_and_at_export(tmp_path, fake_card):
    trace_lib.configure("full", export_env=False)
    tracer = trace_lib._tracer
    fake_card.done = False
    for i in range(5):
        with trace_lib.span("s", device=CARD, i=i):
            fake_card.ms += 1.0
    assert len(tracer._pending) == 5
    tracer._pending[0][2].done = True  # the oldest pair's end completes
    with trace_lib.span("s", device=CARD, i=5):
        fake_card.ms += 1.0
    assert len(tracer._pending) == 5
    assert "dev_dur" in tracer.events()[0]["args"]
    spans = _x_events(trace_lib.export(str(tmp_path / "t.json")))
    assert not tracer._pending
    assert [e["args"]["dev_dur"] for e in spans] == pytest.approx(
        [1000.0] * 6)
    starts = [e["args"]["dev_ts"] for e in spans]
    assert np.diff(starts) == pytest.approx([1000.0] * 5)


@pytest.mark.parametrize("capacity", [1, 4])
def test_ring_holds_no_more_pairs_than_its_capacity(tmp_path, fake_card,
                                                    capacity):
    trace_lib.configure("ring", capacity=capacity, export_env=False)
    tracer = trace_lib._tracer
    fake_card.done = False
    for i in range(3 * capacity + 2):
        with trace_lib.span("s", device=CARD, i=i):
            fake_card.ms += 1.0
        assert len(tracer._pending) <= capacity
    spans = _x_events(trace_lib.export(str(tmp_path / "t.json")))
    assert len(spans) == capacity and trace_lib.dropped() == 2 * capacity + 2
    assert all(e["args"]["dev_dur"] == pytest.approx(1000.0) for e in spans)


def test_the_reference_moves_up_only_past_outermost_spans(tmp_path,
                                                          fake_card):
    """Over a long run the reference moves to the end of an outermost span
    resolved a second or more past it; a span still open then keeps the
    old one, and every start stays exact."""
    trace_lib.configure("full", export_env=False)
    tracer = trace_lib._tracer
    fake_card.ms = 1.0
    with trace_lib.span("first", device=CARD):
        fake_card.ms += 1.0
    anchor = tracer._ref[0]
    fake_card.ms += 1500.0
    with trace_lib.span("long", device=CARD):
        fake_card.ms += 1.0
        with trace_lib.span("child", device=CARD):
            fake_card.ms += 1.0
        assert tracer._ref[0] is anchor  # "long" is still open
        fake_card.ms += 1.0
    assert tracer._ref[0] is not anchor
    with trace_lib.span("after", device=CARD):
        fake_card.ms += 1.0
    ev = {e["name"]: e["args"] for e in _x_events(
        trace_lib.export(str(tmp_path / "t.json")))}
    t0 = ev["first"]["dev_ts"]
    for name, card_ms in (("long", 1502.0), ("child", 1503.0),
                          ("after", 1505.0)):
        assert ev[name]["dev_ts"] - t0 == pytest.approx(
            (card_ms - 1.0) * 1e3)


def test_device_mark_is_the_host_clock_off_the_card(fake_card):
    a = trace_lib.device_mark(torch.device("cpu"))
    b = trace_lib.device_mark("cpu")
    assert isinstance(a, float) and FakeEvent.made == 0
    assert 0.0 <= trace_lib.elapsed_ms(a, b) < 1e3
    e0, e1 = trace_lib.device_mark(CARD), trace_lib.device_mark("cuda:0")
    assert FakeEvent.made == 2
    fake_card.ms += 0.25
    e1.record()
    assert trace_lib.elapsed_ms(e0, e1) == pytest.approx(0.25)


# -- the training step's spans, on the CPU ------------------------------------

V, F, B, K_LOOP = 300, 5, 16, 2


def _cfg(**over):
    kw = dict(feature_size=V, field_size=F, embedding_size=4,
              deep_layers="8,4", dropout="1.0,1.0", batch_size=B,
              steps_per_loop=K_LOOP, learning_rate=0.01, log_steps=0,
              seed=5, compute_dtype="float32", decoded_cache="ram",
              device_dataset=True)
    kw.update(over)
    return Config(**kw)


def _rows(n, seed=3):
    rng = np.random.default_rng(seed)
    return CacheColumns(
        (rng.random(n) < 0.3).astype(np.float32),
        rng.integers(0, V, (n, F)).astype(np.int32),
        rng.random((n, F), dtype=np.float32), np.asarray([n], np.int64))


class Feed:
    """The pipe contract of ``fit_device_resident`` over fixed columns."""

    batch_size, num_epochs, epoch_offset = B, 1, 0
    drop_remainder, health = True, None

    def __init__(self, cols):
        self.cols = cols

    def decoded_epoch_columns(self):
        return self.cols

    def decoded_cache_fingerprint(self):
        return "trace-test"

    def device_epoch_indices(self, epoch, k=1):
        return np.arange(self.cols.num_records, dtype=np.int32)


def _inside(e, outer):
    return (outer["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])


def test_fit_device_resident_emits_every_layer_span(tmp_path):
    """Five batches at two steps a dispatch: dispatches of 2, 2 and 1."""
    trainer = Trainer(_cfg(), device="cpu")
    state = trainer.init_state()
    trace_lib.configure("full", export_env=False)
    state, out = trainer.fit_device_resident(state, Feed(_rows(5 * B)))
    spans = _x_events(trace_lib.export(str(tmp_path / "t.json")))
    steps = int(out["steps"])
    assert steps == 5
    names = [e["name"] for e in spans]
    counts = {n: names.count(n) for n in set(names)}
    assert counts == {**{n: c * steps for n, c in STEP_SPANS.items()},
                      "train.dispatch": 3, "train.feed": 3}
    dispatches = [e for e in spans if e["name"] == "train.dispatch"]
    assert [d["args"]["steps"] for d in dispatches] == [2, 2, 1]
    for name, per_dispatch in (("train.feed", [1, 1, 1]),
                               ("train.step", [2, 2, 1])):
        inner = [e for e in spans if e["name"] == name]
        assert [sum(_inside(e, d) for e in inner)
                for d in dispatches] == per_dispatch
    # On the CPU no span carries device time.
    assert not any("dev_ts" in e.get("args", {}) for e in spans)


def test_spans_change_no_step(tmp_path):
    """Tracing on and off train to the same bits."""
    def run(mode):
        trace_lib.reset()
        if mode != "off":
            trace_lib.configure(mode, capacity=7, export_env=False)
        trainer = Trainer(_cfg(), device="cpu")
        state = trainer.init_state()
        state, _ = trainer.fit_device_resident(state, Feed(_rows(4 * B)))
        return {k: v.detach().clone() for k, v in state.params.items()}

    off, ring = run("off"), run("ring")
    assert all(torch.equal(off[k], ring[k]) for k in off)


def test_timed_fit_reports_dispatch_time_on_the_host_clock(monkeypatch):
    monkeypatch.setenv(loop_lib.TIME_COLLECTIVES_ENV, "1")
    cols = _rows(6 * B)
    batches = [{"label": cols.labels[i:i + B].reshape(-1, 1),
                "feat_ids": cols.ids[i:i + B], "feat_vals": cols.vals[i:i + B]}
               for i in range(0, 6 * B, B)]
    trainer = Trainer(_cfg(device_dataset=False), device="cpu")
    state = trainer.init_state()
    t0 = time.perf_counter()
    state, out = trainer.fit(state, batches)
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert out["steps"] == 6.0
    assert 0.0 < out["dispatch_device_ms"] < wall_ms
    # One process: no all_reduce, so no collective time.
    assert "collective_device_ms" not in out


def test_untimed_fit_reports_no_dispatch_time(monkeypatch):
    monkeypatch.delenv(loop_lib.TIME_COLLECTIVES_ENV, raising=False)
    cols = _rows(2 * B)
    batches = [{"label": cols.labels[i:i + B].reshape(-1, 1),
                "feat_ids": cols.ids[i:i + B], "feat_vals": cols.vals[i:i + B]}
               for i in range(0, 2 * B, B)]
    trainer = Trainer(_cfg(device_dataset=False), device="cpu")
    _, out = trainer.fit(trainer.init_state(), batches)
    assert "dispatch_device_ms" not in out


# -- the clocks, on the card --------------------------------------------------

def _profiled_kernels(prof, path):
    """The kernels of a profiler run in wall µs: (name, start, end)."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0)) / 1e3
    return [(e["name"], base + float(e["ts"]),
             base + float(e["ts"]) + float(e.get("dur", 0)))
            for e in data["traceEvents"]
            if e.get("cat") == "kernel" and e.get("ph") == "X"]


@pytest.mark.card
def test_tracer_clock_matches_the_profilers_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415
    dev = torch.device("cuda")
    cfg = _cfg(feature_size=117581, field_size=39, embedding_size=32,
               deep_layers="128,64,32", batch_size=8192, steps_per_loop=1,
               compute_dtype="bfloat16", device_dataset=False)
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state()
    rng = np.random.default_rng(7)
    batches = [trainer.put_batch({
        "feat_ids": rng.integers(0, 117581, (8192, 39)).astype(np.int32),
        "feat_vals": rng.random((8192, 39), dtype=np.float32),
        "label": (rng.random((8192, 1)) < 0.3).astype(np.float32)})
        for _ in range(4)]
    for b in batches[:2]:  # kernel builds and the allocator's growth
        state, _ = trainer.train_step(state, b)
    x = torch.ones(1 << 20, device=dev)
    trace_lib.configure("full", export_env=False)
    # (a) A host span that launches one kernel on an idle card.
    probes = []
    for i in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with trace_lib.span("clock.probe", device=dev, i=i):
                x.mul_(1.0)
            torch.cuda.synchronize()
        kernels = _profiled_kernels(prof, str(tmp_path / f"a{i}.json"))
        assert len(kernels) == 1, kernels
        probe = [e for e in _x_events(trace_lib.export(
            str(tmp_path / f"s{i}.json"))) if e["name"] == "clock.probe"][-1]
        probes.append((probe, kernels[0]))
    # µs from the host span's start to the kernel's, and from the span's
    # device interval's ends to the kernel's.
    offsets = [(k0 - p["ts"], k0 - p["args"]["dev_ts"],
                p["args"]["dev_ts"] + p["args"]["dev_dur"] - k1)
               for p, (_, k0, k1) in probes]
    for p, (_, k0, _) in probes:
        assert p["ts"] <= k0 <= p["ts"] + p["dur"] + 1000.0, (probes,
                                                              offsets)
    # (b) Dense steps: every embedding backward kernel inside an embed.bwd
    # device interval, 50 µs of slack on each side.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches[2:]:
            state, _ = trainer.train_step(state, b)
        torch.cuda.synchronize()
    kernels = _profiled_kernels(prof, str(tmp_path / "b.json"))
    spans = _x_events(trace_lib.export(str(tmp_path / "b_spans.json")))
    bwd = [(e["args"]["dev_ts"], e["args"]["dev_ts"] + e["args"]["dev_dur"])
           for e in spans if e["name"] == "embed.bwd"]
    emb = [k for k in kernels
           if "take_bwd" in k[0] or "segments_kernel" in k[0]]
    assert len(bwd) == 4 and emb
    for name, k0, k1 in emb:
        assert any(a - 50.0 <= k0 and k1 <= b + 50.0 for a, b in bwd), (
            name, k0, k1, bwd)
    first = [min(k0 for _, k0, _ in emb if a - 50.0 <= k0 <= b) - a
             for a, b in bwd]
    print(f"clock: {torch.cuda.get_device_name(dev)}; one-kernel span: "
          f"kernel start - span ts {[round(o[0], 2) for o in offsets]} us, "
          f"kernel start - dev_ts {[round(o[1], 2) for o in offsets]} us, "
          f"dev end - kernel end {[round(o[2], 2) for o in offsets]} us; "
          f"embed.bwd: first kernel start - dev_ts "
          f"{[round(f, 2) for f in first]} us")
    trace_lib.reset()
