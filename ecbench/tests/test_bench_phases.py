"""The readers of the program's own spans and counters in the EC dispatch
path: the scheduler's window wait, its serial section, the parity
copy-back, and the device's idle time inside the section. Each is read on
a hand-built `Readings` (a synthetic device trace, known phase intervals
and counter snapshots), and reads nothing where the program has nothing
for it: no trace, another op, a program without the spans, or a phase
ring that no longer reaches back to the window's open."""

from types import SimpleNamespace

import pytest

from ecbench import harness, registry
from ecbench import trace as tr

from seaweedfs_tpu_torch.utils import trace as program_trace

from .conftest import cpu_coder

NEW = ("dispatch_window_wait_ms.encode", "dispatch_section_share.encode",
       "pipeline_copy_out_share.encode", "idle_in_dispatch_share.encode")
SUM = "SeaweedFS_ec_dispatch_window_wait_seconds_sum"
COUNT = "SeaweedFS_ec_dispatch_window_wait_seconds_count"
PHASES = "SeaweedFS_ec_phase_seconds"
ENC = (("chip", "-"), ("lane", "encode"))
REC = (("chip", "-"), ("lane", "reconstruct"))


def _summary():
    """Busy [1000, 1160), [1500, 1610), [1950, 2000) us of the window
    [1000, 2000); idle [1160, 1500) and [1610, 1950), 680 us. The mark at
    1000 us was perf_counter 5.0 s, so host time = us / 1e6 + 4.999."""
    events = [
        tr.DeviceEvent("Memcpy HtoD (Pageable -> Device)", tr.MEMCPY, 900,
                       1100),
        tr.DeviceEvent("gf_xor_kernel", tr.KERNEL, 1100, 1160),
        tr.DeviceEvent("Memcpy DtoH (Device -> Pageable)", tr.MEMCPY, 1500,
                       1600),
        tr.DeviceEvent("Memset (Device)", tr.MEMSET, 1600, 1610),
        tr.DeviceEvent("gf_xor_kernel", tr.KERNEL, 1950, 2100),
    ]
    return tr.summarize(events, 1000.0, 5.0, 5.0, 5.001)


def _host(us: float) -> float:
    return us / 1e6 + 4.999


def _readings(summary=None, op="encode", seconds=2.0, before=None,
              after=None, rounds=()):
    return harness.Readings(op, seconds, 1, 0.0, list(rounds), before or {},
                            after or {}, summary, 0, None)


@pytest.fixture
def reg():
    return registry.Registry()


@pytest.fixture
def store(monkeypatch):
    """A fresh phase store of 16 intervals in the program's place."""
    fresh = program_trace.TraceStore(ring_spans=16, retain_traces=4,
                                     phase_ring=16)
    monkeypatch.setattr(program_trace, "STORE", fresh)
    return fresh


def test_the_registry_lists_the_four_under_trace_only(reg):
    traced = {m["name"] for m in reg.metrics_for("rs6_3.encode8", True)}
    plain = {m["name"] for m in reg.metrics_for("rs6_3.encode8", False)}
    assert set(NEW) <= traced
    assert not set(NEW) & plain
    for name in NEW:
        assert callable(reg.reader(name))


def test_window_wait_is_the_change_of_the_sum_over_that_of_the_count(reg):
    read = reg.reader("dispatch_window_wait_ms.encode")
    before = {SUM: {ENC: 1.0, REC: 4.0}, COUNT: {ENC: 10, REC: 1}}
    after = {SUM: {ENC: 1.5, REC: 9.0}, COUNT: {ENC: 20, REC: 2}}
    r = _readings(_summary(), before=before, after=after)
    # 0.5 s over 10 slabs of the encode lane; the reconstruct lane's
    # slabs count for nothing
    assert read(r, "encode") == pytest.approx(50.0)
    assert read(_readings(None, before=before, after=after),
                "encode") is None
    assert read(_readings(_summary(), op="rebuild", before=before,
                          after=after), "encode") is None
    # a program without the counters, or a window without a flush
    assert read(_readings(_summary()), "encode") is None
    assert read(_readings(_summary(), before=after, after=after),
                "encode") is None


def test_section_share_is_the_sections_seconds_over_the_window(reg):
    read = reg.reader("dispatch_section_share.encode")
    sec = (("lane", "encode"), ("phase", "ec.dispatch.section"))
    pack = (("lane", "encode"), ("phase", "ec.dispatch.pack"))
    rec = (("lane", "reconstruct"), ("phase", "ec.dispatch.section"))
    before = {PHASES: {sec: 2.0, pack: 1.0, rec: 0.0}}
    after = {PHASES: {sec: 2.5, pack: 1.4, rec: 0.3}}
    r = _readings(_summary(), seconds=2.0, before=before, after=after)
    assert read(r, "encode") == pytest.approx(25.0)
    assert read(_readings(None, before=before, after=after),
                "encode") is None
    assert read(_readings(_summary(), op="rebuild", before=before,
                          after=after), "encode") is None
    assert read(_readings(_summary()), "encode") is None


def test_copy_out_share_reads_the_same_rounds_as_the_device_wait(reg):
    read = reg.reader("pipeline_copy_out_share.encode")
    wait = reg.reader("pipeline_device_wait_share.encode")
    rounds = [SimpleNamespace(wall_s=10.0, device_wait_s=8.0,
                              copy_out_s=1.0),
              SimpleNamespace(wall_s=6.0, device_wait_s=5.0,
                              copy_out_s=0.6)]
    r = _readings(_summary(), rounds=rounds)
    assert read(r, "encode") == pytest.approx(10.0)
    assert wait(r, "encode") == pytest.approx(100 * 13.0 / 16.0)
    assert read(_readings(None, rounds=rounds), "encode") is None
    assert read(_readings(_summary(), op="rebuild", rounds=rounds),
                "encode") is None
    # a program whose stats have no copy-back
    older = [SimpleNamespace(wall_s=10.0, device_wait_s=8.0)]
    assert read(_readings(_summary(), rounds=older), "encode") is None
    assert read(_readings(_summary()), "encode") is None


def test_idle_in_dispatch_maps_the_sections_onto_the_devices_gaps(reg,
                                                                  store):
    read = reg.reader("idle_in_dispatch_share.encode")
    sec = "ec.dispatch.section"
    # [1100, 1300) us covers 140 us of the first gap, [1700, 1800) 100 us
    # of the second; a pack and a reconstruct section are not counted
    store.record_phase(sec, "encode", _host(1100), _host(1300))
    store.record_phase(sec, "encode", _host(1700), _host(1800))
    store.record_phase("ec.dispatch.pack", "encode", _host(1200),
                       _host(1950))
    store.record_phase(sec, "reconstruct", _host(1200), _host(1950))
    r = _readings(_summary())
    assert read(r, "encode") == pytest.approx(100 * 240 / 680)
    assert read(_readings(None), "encode") is None
    assert read(_readings(_summary(), op="rebuild"), "encode") is None


def test_idle_in_dispatch_reads_nothing_once_the_ring_lost_the_open(
        reg, store):
    read = reg.reader("idle_in_dispatch_share.encode")
    store.record_phase("ec.dispatch.section", "encode", _host(1100),
                       _host(1300))
    # sixteen more intervals push the one inside the window out
    for i in range(16):
        store.record_phase("ec.dispatch.pack", "encode", _host(1900 + i),
                           _host(1901 + i))
    got, whole = program_trace.phase_intervals(
        "ec.dispatch.section", "encode", _host(1000), _host(2000))
    assert got == [] and whole is False
    assert read(_readings(_summary()), "encode") is None


def test_idle_in_dispatch_reads_nothing_from_a_program_without_phases(
        reg, monkeypatch):
    monkeypatch.delattr(program_trace, "phase_intervals")
    read = reg.reader("idle_in_dispatch_share.encode")
    assert read(_readings(_summary()), "encode") is None


def test_a_traced_run_on_the_cpu_reads_all_four(tiny):
    """The program's CPU coder through a traced run: the profiler sees no
    device, so the card is idle all the window, and every reader finds
    its spans and counters."""
    res = harness.run("tiny.encode2", 2**31 + 29, 1.0, True, registry=tiny,
                      coder_factory=cpu_coder, dev="cpu", require_card=False)
    assert res["correct"] is True
    got = {name: res["metrics"][name]["value"] for name in NEW}
    assert got["dispatch_window_wait_ms.encode"] > 0
    for name in NEW[1:]:
        assert 0 < got[name] <= 100, (name, got[name])
    assert res["metrics"]["device_idle_share.encode"]["value"] == 100.0
