"""The phases of the port's EC dispatch path (utils/trace.phase): the
scheduler's serial section and pack, the codec's copy in and launch, the
encode pipeline's copy back; their totals (SeaweedFS_ec_phase_seconds),
their ring, and the scheduler's window wait read as counters.

Two RS(6,3) volumes encode at once through one scheduler on a CPU
`RSCodecTorch`, whose products run the kernels' plain PyTorch versions.
Every comparison of bytes is exact."""

import hashlib
import json
import os
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ops import dispatch
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.storage import ec_files
from seaweedfs_tpu_torch.storage.ec_locate import Geometry
from seaweedfs_tpu_torch.utils import stats, trace

K, M = 6, 3
GEO = Geometry(K, M, large_block=8192, small_block=512)
SECTION, PACK = "ec.dispatch.section", "ec.dispatch.pack"
COPY_IN, LAUNCH = "ec.codec.copy_in", "ec.codec.launch"
COPY_OUT = "ec.encode.copy_out"


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    """One torch thread; tracing on, re-read now; a fresh phase store in
    the program's place; every scheduler closed after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv("SWFS_TRACE", raising=False)
    monkeypatch.setenv("SWFS_EC_DISPATCH", "1")
    # a wide window, so the two volumes' slabs meet in flushes
    monkeypatch.setenv("SWFS_EC_DISPATCH_WINDOW_MS", "20")
    monkeypatch.setattr(trace, "STORE", trace.TraceStore())
    trace.refresh_config()
    yield
    dispatch.shutdown_all()
    torch.set_num_threads(n)
    trace.refresh_config()


def _volume(base: str, seed: int) -> None:
    """A .dat of random bytes that walks large and small rows."""
    rng = np.random.default_rng(seed)
    size = K * 8192 * 2 + 5 * 512 + 77
    rng.integers(0, 256, size, dtype=np.uint8).tofile(base + ".dat")


def _shards(base: str) -> list[str]:
    out = []
    for i in range(K + M):
        with open(f"{base}.ec{i:02d}", "rb") as f:
            out.append(hashlib.sha256(f.read()).hexdigest())
    return out


def _encode_two(tmp_path, tag: str):
    """Two volumes at once through one CPU codec's scheduler ->
    ([EncodeStats], [shard hashes])."""
    coder = RSCodecTorch(K, M, device="cpu")
    bases = []
    for v in range(2):
        os.makedirs(tmp_path / f"{tag}{v}")
        bases.append(str(tmp_path / f"{tag}{v}" / "1"))
        _volume(bases[-1], seed=v)
    got = [None, None]
    errors = []

    def run(v):
        try:
            got[v] = ec_files.generate_ec_files(bases[v], coder, GEO,
                                                batch_size=512)
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(v,)) for v in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return got, [_shards(b) for b in bases]


def _held(name: str, lane: str) -> list[tuple[float, float]]:
    got, whole = trace.phase_intervals(name, lane, 0.0, float("inf"))
    assert whole
    return got


def test_sections_are_serial_and_hold_every_pack_copy_and_launch(tmp_path):
    encodes, _ = _encode_two(tmp_path, "on")
    sections = sorted(_held(SECTION, "encode"))
    assert sections
    for (_, end), (start, _) in zip(sections, sections[1:]):
        assert end <= start  # one mutex: no two sections overlap
    inner = {name: _held(name, "encode") for name in (PACK, COPY_IN,
                                                     LAUNCH)}
    assert inner[PACK], "no flush stacked two slabs"
    assert len(inner[LAUNCH]) >= len(inner[PACK])
    for name, held in inner.items():
        for a, b in held:
            assert any(s <= a and b <= e for s, e in sections), (name, a, b)
    # the codec's phases ran only inside flushes, so none lacks a lane
    assert not _held(COPY_IN, "-") and not _held(LAUNCH, "-")
    # one copy back per slab, on the coordinators' threads
    assert len(_held(COPY_OUT, "encode")) == sum(s.batches for s in encodes)
    for s in encodes:
        assert 0 < s.copy_out_s <= s.device_wait_s < s.wall_s
    # the totals are the ring's intervals summed
    totals = stats.EC_PHASE_SECONDS.split_by("phase", lane="encode")
    for name in (SECTION, PACK, COPY_IN, LAUNCH, COPY_OUT):
        assert totals[name] == pytest.approx(
            sum(b - a for a, b in _held(name, "encode")))


def test_tracing_off_records_nothing_and_changes_no_byte(tmp_path,
                                                        monkeypatch):
    _, traced = _encode_two(tmp_path, "on")
    store = trace.TraceStore()
    monkeypatch.setattr(trace, "STORE", store)
    monkeypatch.setenv("SWFS_TRACE", "0")
    trace.refresh_config()
    encodes, untraced = _encode_two(tmp_path, "off")
    assert untraced == traced
    assert store.phase_seconds() == {}
    assert store.phase_intervals(SECTION, "encode", 0.0,
                                 float("inf")) == ([], True)
    # the pipeline's own timers run either way
    assert all(0 < s.copy_out_s <= s.device_wait_s for s in encodes)


def test_the_phase_ring_stays_at_its_bound():
    store = trace.TraceStore(phase_ring=16)
    for i in range(40):
        store.record_phase(SECTION, "encode", float(i), i + 0.5)
    assert len(store._phases) == 16
    assert not store._ring  # the request ring is another
    got, whole = store.phase_intervals(SECTION, "encode", 30.0, 99.0)
    assert got == [(float(i), i + 0.5) for i in range(30, 40)] and whole
    # interval 23 is gone, and it ended after 23.0
    got, whole = store.phase_intervals(SECTION, "encode", 23.0, 99.0)
    assert got[0] == (24.0, 24.5) and not whole
    # the totals keep every interval
    assert store.phase_seconds() == {(SECTION, "encode"): 20.0}


def test_a_phase_takes_the_lane_of_the_phase_around_it():
    with trace.phase("outer", lane="reconstruct"):
        with trace.phase("inner"):
            pass
    with trace.phase("alone"):
        pass
    seconds = trace.STORE.phase_seconds()
    assert set(seconds) == {("outer", "reconstruct"),
                            ("inner", "reconstruct"), ("alone", "-")}


def test_a_phase_is_a_profiler_range_while_one_records(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with trace.phase("ec.test.unrecorded"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.phase("ec.test.recorded", lane="encode"):
            torch.zeros(4).add_(1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "ec.test.recorded" in names
    assert "ec.test.unrecorded" not in names


def test_window_wait_sum_and_count_are_counters_that_snapshots_read():
    coder = RSCodecTorch(K, M, device="cpu")
    sched = dispatch.scheduler_for(coder)
    np.asarray(sched.encode_parity(np.zeros((K, 64), np.uint8)))
    # the harness's snapshot reads the registry's Counters (Gauges aside)
    counters = {m.name: m for m in stats._REGISTRY
                if isinstance(m, stats.Counter)
                and not isinstance(m, stats.Gauge)}
    want = stats.EC_DISPATCH_WINDOW_WAIT.snapshot(lane="encode")
    name = "SeaweedFS_ec_dispatch_window_wait_seconds"
    assert counters[name + "_count"].value(lane="encode") == want["count"]
    assert counters[name + "_sum"].value(lane="encode") == \
        pytest.approx(want["sum"])
    assert want["count"] >= 1
    # /metrics carries each series once, under the histogram
    text = stats.gather()
    assert f"# TYPE {name} histogram" in text
    assert f"# TYPE {name}_sum" not in text
    assert f"# TYPE {name}_count" not in text
    assert "\n\n" not in text
    assert "SeaweedFS_ec_phase_seconds{" in text


def test_the_zero_fill_counter_is_gone():
    assert not hasattr(stats, "EC_DISPATCH_ZEROFILL_ELIDED")
    assert "zerofill" not in stats.gather()
    assert "zeroFillElidedBytes" not in stats.ec_dispatch_stats()["arena"]
