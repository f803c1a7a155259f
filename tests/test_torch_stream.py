"""The port's unbounded shard stream (``data.stream.UnboundedFileStream``)
against the JAX package's, on the CPU.

Each scenario scripts one arrival schedule (files written, re-delivered,
removed or shrunk between polls, in directory and manifest modes) and runs
it twice in a fresh directory: once through each package's stream, with an
injected clock and sleep. Both must serve the same bytes, write the same
``stream_manifest.json`` and count the same late, duplicate and torn files
and discarded bytes (tolerance: none). A restart from the sidecar replays
the same stream in both.
"""

import json
import os
import shutil

import pytest
import torch

from deepfm_tpu.data import stream as jax_stream
from deepfm_tpu.data.health import DataHealth as JaxDataHealth
from deepfm_tpu_torch.data import fileio, stream
from deepfm_tpu_torch.data.health import DataHealth

torch.set_num_threads(1)

SIDES = {"port": (stream.UnboundedFileStream, DataHealth),
         "jax": (jax_stream.UnboundedFileStream, JaxDataHealth)}
COUNTERS = ("late_files", "duplicate_files", "torn_files",
            "bytes_discarded", "read_retries")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, secs):
        self.t += max(float(secs), 0.01)


class World:
    """One run of a scenario against one side's stream class."""

    def __init__(self, root, side):
        self.root = str(root)
        self.src = os.path.join(self.root, "src")
        os.makedirs(self.src)
        self.side = side
        self.sidecar = os.path.join(self.root, "stream_manifest.json")
        self.out = bytearray()
        self.stream = None

    def write(self, name, data, where=None):
        path = os.path.join(where or self.src, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        return path

    def open(self, source=None, **kw):
        cls, health = SIDES[self.side]
        clock = FakeClock()
        kw.setdefault("pattern", "*.bin")
        kw.setdefault("idle_timeout_secs", 1.0)
        self.stream = cls(source or self.src, sidecar_path=self.sidecar,
                          poll_secs=0.1, health=health(), clock=clock,
                          sleep=clock.sleep, **kw)
        return self.stream

    def poll(self):
        return [self.stream.poll_now(), self.stream.poll_now()]

    def read(self, n):
        b = self.stream.read(n)
        self.out += b
        return b

    def drain(self):
        while self.read(7):
            pass

    def result(self):
        side = open(self.sidecar).read() if os.path.exists(self.sidecar) \
            else None
        h = self.stream.health
        return (bytes(self.out), side, {c: getattr(h, c) for c in COUNTERS},
                [os.path.relpath(p, self.root)
                 for p in self.stream.files_admitted])


def sc_directory(w):
    w.write("b.bin", b"bbbbbbbbbb")
    w.open()
    w.poll()
    w.read(4)
    w.write("c.bin", b"cc")
    w.write("a.bin", b"late-a")  # sorts before the admitted b.bin
    w.poll()
    w.read(100)
    w.write("d.bin", b"dddd")
    w.write("e.bin", b"")  # never admitted while empty
    w.poll()
    w.drain()


def sc_manifest(w):
    a = w.write("a.bin", b"AAAA")
    dup = w.write("a.bin", b"second copy", where=os.path.join(w.src, "re"))
    manifest = os.path.join(w.root, "manifest.txt")
    with open(manifest, "w") as f:
        f.write(f"# shards\n{a}\n{dup}\n{w.src}/missing.bin\n")
    w.open(source=manifest)
    w.poll()
    w.read(3)
    w.write("missing.bin", b"now-here")
    c = w.write("c.bin", b"CC")
    with open(manifest, "a") as f:
        f.write(f"{c}\n")
    w.poll()
    w.drain()


def sc_torn(w):
    doomed = w.write("a.bin", b"gone!")
    shrinking = w.write("b.bin", b"0123456789")
    w.write("c.bin", b"kept")
    w.open()
    w.poll()
    os.unlink(doomed)
    with open(shrinking, "wb") as f:
        f.write(b"0123")
    w.drain()


def sc_growth_after_admission(w):
    path = w.write("a.bin", b"12345")
    w.open()
    w.poll()
    with open(path, "ab") as f:
        f.write(b"LATE")
    w.drain()


SCENARIOS = {f.__name__[3:]: f for f in (sc_directory, sc_manifest, sc_torn,
                                         sc_growth_after_admission)}


def _run(tmp_path, scenario, side):
    root = tmp_path / "world"
    if root.exists():
        shutil.rmtree(root)
    w = World(root, side)
    SCENARIOS[scenario](w)
    return w


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_same_stream_sidecar_and_counts_as_jax(tmp_path, scenario):
    jax_side = _run(tmp_path, scenario, "jax").result()
    port = _run(tmp_path, scenario, "port").result()
    assert port == jax_side
    assert port[0]  # the scenario served data


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_sidecar_replay_equals_jax(tmp_path, scenario):
    """A restart on each side's sidecar serves the admitted files at their
    recorded sizes, without a poll, in admission order."""
    replays = {}
    for side in ("jax", "port"):
        w = _run(tmp_path, scenario, side)
        w.stream.close()
        source = w.stream._source
        w.out = bytearray()
        w.open(source=source, idle_timeout_secs=0.05)
        w.drain()
        replays[side] = w.result()
    assert replays["port"] == replays["jax"]


def test_sidecar_written_before_bytes_served(tmp_path):
    w = World(tmp_path, "port")
    w.write("a.bin", b"x" * 8)
    w.open()
    w.poll()
    meta = json.loads(open(w.sidecar).read())
    assert [os.path.basename(p) for p, _ in meta["admitted"]] == ["a.bin"]
    assert meta["admitted"][0][1] == 8 and meta["version"] == 1


def test_corrupt_sidecar_warns_and_starts_fresh(tmp_path):
    w = World(tmp_path, "port")
    with open(w.sidecar, "w") as f:
        f.write('{"version": 1, "adm')
    w.write("a.bin", b"ok")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        w.open()
    w.poll()
    w.drain()
    assert bytes(w.out) == b"ok"


def test_request_stop_wakes_a_blocked_poll(tmp_path):
    """With no idle timeout a read waits for new shards; request_stop (the
    preemption path) wakes it: EOF, with no real sleep in between."""
    import threading
    import time
    s = stream.UnboundedFileStream(str(tmp_path), poll_secs=30.0)
    threading.Timer(0.2, s.request_stop).start()
    t0 = time.monotonic()
    assert s.read(10) == b""
    assert time.monotonic() - t0 < 10 and s.stopped


def test_write_atomic_and_glob(tmp_path):
    p = str(tmp_path / "x.json")
    fileio.write_atomic(p, "one")
    fileio.write_atomic(p, b"two")
    assert open(p).read() == "two"
    assert fileio.glob(str(tmp_path / "*.json")) == [p]
    assert [n for n in os.listdir(tmp_path) if ".tmp" in n] == []
