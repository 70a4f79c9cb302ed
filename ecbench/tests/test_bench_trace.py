"""The metric arithmetic on a small synthetic device trace."""

import json

import pytest

from ecbench import harness, registry
from ecbench import trace as tr


def _events():
    # us on the profiler clock; the window is [1000, 2000)
    return [
        tr.DeviceEvent("Memcpy HtoD (Pageable -> Device)", tr.MEMCPY, 900,
                       1100),  # 100 us inside
        tr.DeviceEvent("gf_xor_kernel", tr.KERNEL, 1100, 1150),
        tr.DeviceEvent("gf_xor_kernel", tr.KERNEL, 1140, 1160),  # overlaps
        tr.DeviceEvent("Memcpy DtoH (Device -> Pageable)", tr.MEMCPY, 1500,
                       1600),
        tr.DeviceEvent("Memset (Device)", tr.MEMSET, 1600, 1610),
        tr.DeviceEvent("gf_xor_kernel", tr.KERNEL, 1950, 2100),  # 50 inside
    ]


def _summary():
    # the mark at 1000 us was perf_counter 5.0 s; the window 5.0-5.001 s
    return tr.summarize(_events(), 1000.0, 5.0, 5.0, 5.001)


def _readings(summary, op="encode", kernel_bytes=0, rate=None, nbytes=0):
    return harness.Readings(op, summary.window_s, nbytes, 0.0, [], {}, {},
                            summary, kernel_bytes, rate)


def test_union_gaps_and_clipping():
    s = _summary()
    assert s.lo == pytest.approx(1000) and s.hi == pytest.approx(2000)
    # busy: [1000,1160) + [1500,1610) + [1950,2000) = 160 + 110 + 50
    assert s.busy_s() == pytest.approx(320e-6)
    assert s.busy_s(kinds=(tr.MEMCPY,)) == pytest.approx(200e-6)
    # kernels summed, overlap counted twice: 50 + 20 + 50
    assert s.summed_s(tr.KERNEL) == pytest.approx(120e-6)
    assert tr.gaps(tr.merge([(1, 2), (4, 5)]), 0, 6) == [(0, 1), (2, 4),
                                                       (5, 6)]


def test_idle_copy_and_roofline_shares():
    reg = registry.Registry()
    s = _summary()
    r = _readings(s, kernel_bytes=120, rate=1e9)  # 120 B at 1 GB/s: 0.12 us
    idle = reg.reader("device_idle_share.encode")(r, "encode")
    assert idle == pytest.approx(100 * (1 - 320 / 1000))
    copy = reg.reader("copy_busy_share.encode")(r, "encode")
    assert copy == pytest.approx(100 * 200 / 1000)
    roof = reg.reader("gf_kernels_roofline.encode")(r, "encode")
    assert roof == pytest.approx(100 * 0.12 / 120)
    # the other lane's variant, and a run without a trace, read nothing
    assert reg.reader("device_idle_share.encode")(r, "rebuild") is None
    assert reg.reader("gf_kernels_roofline.encode")(
        _readings(s, kernel_bytes=0, rate=1e9), "encode") is None


def test_the_busy_rate_counts_the_bytes_over_the_cards_busy_time():
    reg = registry.Registry()
    s = _summary()
    r = _readings(s, nbytes=640_000)  # 640 kB over 320 us busy: 2 GB/s
    assert reg.reader("encode_busy_GBps")(r, "") == pytest.approx(2.0)
    # the wall rate takes the whole window: 640 kB over 1 ms
    assert reg.reader("encode_GBps.wall")(r, "wall") == pytest.approx(0.64)
    # without a trace, or on a card that did nothing, it reads nothing
    none = harness.Readings("encode", 1.0, 1, 0.0, [], {}, {}, None, 0, None)
    assert reg.reader("encode_busy_GBps")(none, "") is None
    idle = tr.summarize([], 1000.0, 5.0, 5.0, 5.001)
    assert reg.reader("encode_busy_GBps")(_readings(idle, nbytes=1), "") \
        is None


def test_idle_gaps_are_named_by_the_streams():
    s = _summary()
    timeline = tr.Timeline()
    timeline._marks["v1"] = [(4.0, "encode:await_parity")]
    timeline._marks["v2"] = [(4.0, "encode:data_rows"),
                             (5.0007, "encode:await_parity")]
    gaps = s.idle_gaps(timeline)
    # the longest gap, [1160, 1500) us, has its middle at 5.00033 s
    assert gaps[0] == [
        "encode:await_parity x1, encode:data_rows x1", pytest.approx(340e-6)]
    # [1610, 1950): both streams await parity
    assert gaps[1] == ["encode:await_parity x2", pytest.approx(340e-6)]


def test_chrome_trace_is_read_by_category(tmp_path):
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": tr.CLOCK_MARK,
         "ts": 10, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "gf_xor_kernel", "ts": 20,
         "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30,
         "dur": 2},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 40,
         "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 20,
         "dur": 50},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 20},
    ]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(doc))
    events, mark = tr.read_chrome_trace(str(path))
    assert mark == 10
    assert [(e.kind, e.start, e.end) for e in events] == [
        (tr.KERNEL, 20, 25), (tr.MEMCPY, 30, 32), (tr.MEMSET, 40, 41)]
