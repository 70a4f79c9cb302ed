"""The port's EC dispatch scheduler (seaweedfs_tpu_torch/ops/dispatch.py)
against the JAX package's (seaweedfs_tpu/ops/dispatch.py), each on a CPU
coder, and the port's EC lifecycle of concurrent volumes through it.

Mirrors tests/test_ec_dispatch.py, tests/test_ec_memplane.py and the
geometry-lane case of tests/test_geometry.py where they apply to one
device: stacked results equal per-slab results and the reference's,
lanes keep FIFO order and never mix geometries, demand flush, error
propagation, clean shutdown, the env gate, the arena quarantine, the
reconstructed-interval cache and the lock witness. Inputs come from
numpy seeds; every comparison of bytes is exact (tolerance 0)."""

import hashlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import dispatch as ref_dispatch
from seaweedfs_tpu.ops.rs_cpu import RSCodecCPU as RefCPU
from seaweedfs_tpu.ops.rs_jax import RSCodecJax
from seaweedfs_tpu.storage import ec_files as ref_ec_files
from seaweedfs_tpu.storage import ec_volume as ref_ec_volume
from seaweedfs_tpu.storage.ec_locate import Geometry as RefGeometry
from seaweedfs_tpu_torch.models import geometry
from seaweedfs_tpu_torch.models.coder import new_coder
from seaweedfs_tpu_torch.ops import dispatch, rs_sel, rs_xor
from seaweedfs_tpu_torch.ops.rs_cpu import RSCodecCPU
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.storage import ec_files, ec_volume, idx, types
from seaweedfs_tpu_torch.storage.ec_locate import Geometry
from seaweedfs_tpu_torch.utils import locks, stats, trace

LARGE, SMALL = 10000, 100
LOST = (0, 5, 13)
DEGRADED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs beside other
    workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_flushers() -> list:
    return [s._thread for s in list(dispatch._schedulers)
            if s._thread is not None and s._thread.is_alive()]


@pytest.fixture(autouse=True)
def _clean_schedulers():
    """Every port scheduler a test made is closed after it, its flusher
    joined; and the port's lock witness records no violation."""
    before = len(locks.violations())
    yield
    dispatch.shutdown_all()
    ref_dispatch.shutdown_all()
    assert not _port_flushers(), "leaked ec-dispatch flusher thread"
    after = locks.violations()
    assert len(after) <= before, after[before:]


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _coder(kind: str, monkeypatch, geom=None):
    if kind == "cpu":
        return new_coder(10, 4, backend="cpu", geometry=geom)
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", kind)
    return RSCodecTorch(10, 4, geometry=geom, device="cpu")


# -- stacked results ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["cpu", "sel", "xor"])
def test_stacked_encode_matches_per_slab_and_reference(kind, monkeypatch):
    """Ragged slabs in one lane flush as one product; each future equals
    its own encode_parity call and the reference scheduler's result."""
    coder = _coder(kind, monkeypatch)
    widths = [512, 100, 37, 512, 1]
    rng = _rng(1)
    slabs = [rng.integers(0, 256, (10, w), dtype=np.uint8) for w in widths]
    sched = dispatch.EcDispatchScheduler(coder, window=60.0)
    ref = ref_dispatch.EcDispatchScheduler(RefCPU(10, 4), window=60.0)
    b0 = stats.EC_DISPATCH_BATCHES.value(lane="encode")
    futs = [sched.encode_parity(s) for s in slabs]
    ref_futs = [ref.encode_parity(s) for s in slabs]
    for s, f, rf in zip(slabs, futs, ref_futs):
        got = np.asarray(f)
        assert got.dtype == np.uint8 and got.shape == (4, s.shape[1])
        assert np.array_equal(got, _np(coder.encode_parity(s)))
        assert np.array_equal(got, np.asarray(rf))
    assert stats.EC_DISPATCH_BATCHES.value(lane="encode") - b0 == 1
    assert {f.batch_slabs for f in futs} == {len(slabs)}
    sched.close()
    ref.close()


@pytest.mark.parametrize("data_only", [False, True])
@pytest.mark.parametrize("kind", ["cpu", "sel"])
def test_reconstruct_lanes_over_survivor_permutations(kind, data_only,
                                                      monkeypatch):
    """Slabs of one survivor order share a lane; every permutation
    reconstructs what the reference coder does."""
    coder = _coder(kind, monkeypatch)
    ref = RefCPU(10, 4)
    rng = _rng(3)
    sched = dispatch.EcDispatchScheduler(coder, window=60.0)
    for trial in range(3):
        ids = list(range(14))
        rng.shuffle(ids)
        pres = tuple(ids[:10 + trial])
        blocks = []
        futs = []
        for w in (333, 64, 1):
            data = rng.integers(0, 256, (10, w), dtype=np.uint8)
            shards = np.concatenate([data, ref.encode_parity(data)])
            stk = np.stack([shards[i] for i in pres])
            blocks.append((shards, stk))
            futs.append(sched.reconstruct_stacked(pres, stk,
                                                  data_only=data_only))
        # a blocked reconstruct consumer waits out one window before it
        # demand-flushes (serving-side micro-batching): flush now instead
        sched.flush()
        for (shards, stk), f in zip(blocks, futs):
            mids, rows = f.result()
            want_mids, want_rows = ref.reconstruct_stacked(
                pres, stk, data_only=data_only)
            assert tuple(mids) == tuple(want_mids)
            assert np.array_equal(_np(rows), want_rows)
            for j, mid in enumerate(mids):
                assert np.array_equal(_np(rows[j]), shards[mid])
        assert {f.batch_slabs for f in futs} == {3}
    sched.close()


def test_reconstruct_want_reads_only_the_local_group(monkeypatch):
    """Minimal-read form on lrc_10_2_2: a lost data shard solved from its
    5-shard local group, through the scheduler, equals the reference."""
    coder = _coder("sel", monkeypatch, geom="lrc_10_2_2")
    ref = RefCPU(10, 4, geometry="lrc_10_2_2")
    data = _rng(4).integers(0, 256, (10, 257), dtype=np.uint8)
    shards = np.concatenate([data, ref.encode_parity(data)])
    plan = geometry.get("lrc_10_2_2").repair_plan((2,), tuple(
        i for i in range(14) if i != 2))
    assert len(plan.reads) == 5
    stk = np.stack([shards[i] for i in plan.reads])
    mids, rows = dispatch.reconstruct_now(coder, plan.reads, stk,
                                          want=(2,))
    want_mids, want_rows = ref.reconstruct_stacked(plan.reads, stk,
                                                   want=(2,))
    assert tuple(mids) == tuple(want_mids) == (2,)
    assert np.array_equal(_np(rows), want_rows)
    assert np.array_equal(_np(rows[0]), shards[2])


def test_geometries_never_share_a_dispatch():
    """rs_10_4 and lrc_10_2_2 have the same (k, m) but different
    generators: their coders get distinct schedulers, and every lane key
    carries the geometry id."""
    rng = _rng(41)
    data = rng.integers(0, 256, (10, 64), np.uint8)
    lrc = new_coder(10, 4, backend="cpu", geometry="lrc_10_2_2")
    rs = new_coder(10, 4, backend="cpu")
    s_lrc, s_rs = dispatch.scheduler_for(lrc), dispatch.scheduler_for(rs)
    assert s_lrc is not s_rs and dispatch.scheduler_for(lrc) is s_lrc
    s_lrc.window = s_rs.window = 60.0
    assert (s_lrc.geom_id, s_rs.geom_id) == ("lrc_10_2_2", "rs_10_4")
    f_lrc = s_lrc.encode_parity(data)
    f_rs = s_rs.encode_parity(data)
    pres = tuple(range(10))
    f_rec = s_lrc.reconstruct_stacked(pres, data, want=(10,))
    with s_lrc._cv:
        keys = list(s_lrc._lanes)
    assert keys == [("enc", "lrc_10_2_2"),
                    ("rec", "lrc_10_2_2", pres, False, (10,))]
    with s_rs._cv:
        assert list(s_rs._lanes) == [("enc", "rs_10_4")]
    s_lrc.flush()
    lrc_parity = np.asarray(f_lrc)
    assert np.array_equal(lrc_parity, RefCPU(
        10, 4, geometry="lrc_10_2_2").encode_parity(data))
    assert np.array_equal(np.asarray(f_rs), RefCPU(10, 4).encode_parity(data))
    assert not np.array_equal(lrc_parity, np.asarray(f_rs))
    mids, rows = f_rec.result()
    assert tuple(mids) == (10,) and np.array_equal(rows[0], lrc_parity[0])


# -- scheduler semantics ------------------------------------------------------


def test_flush_window_fifo_ordering_and_batching():
    coder = RSCodecCPU(10, 4)
    sched = dispatch.EcDispatchScheduler(coder, window=0.25)
    rng = _rng(5)
    slabs = [rng.integers(0, 256, (10, 64 + 8 * i), dtype=np.uint8)
             for i in range(6)]
    b0 = stats.EC_DISPATCH_BATCHES.value(lane="encode")
    futs = [sched.encode_parity(s) for s in slabs]
    for s, f in zip(slabs, futs):
        assert np.array_equal(np.asarray(f), coder.encode_parity(s))
    assert stats.EC_DISPATCH_BATCHES.value(lane="encode") - b0 < len(slabs)
    sched.close()


def test_lane_cap_flushes_on_the_submitter():
    coder = RSCodecCPU(10, 4)
    sched = dispatch.EcDispatchScheduler(coder, window=60.0, max_slabs=3)
    data = np.ones((10, 16), np.uint8)
    futs = [sched.encode_parity(data) for _ in range(3)]
    assert all(f.done() for f in futs) and sched.pending() == 0
    assert futs[0].batch_slabs == 3
    sched.close()


def test_demand_flush_no_window_stall():
    coder = RSCodecCPU(10, 4)
    sched = dispatch.EcDispatchScheduler(coder, window=30.0)
    data = np.arange(640, dtype=np.uint8).reshape(10, 64)
    t0 = time.perf_counter()
    out = np.asarray(sched.encode_parity(data).result(timeout=10))
    assert time.perf_counter() - t0 < 5.0
    assert np.array_equal(out, coder.encode_parity(data))
    sched.close()


def test_clean_shutdown_joins_flusher():
    coder = RSCodecCPU(10, 4)
    sched = dispatch.scheduler_for(coder)
    np.asarray(sched.encode_parity(np.zeros((10, 32), dtype=np.uint8)))
    sched.close()
    assert sched.closed and not _port_flushers()
    with pytest.raises(RuntimeError, match="closed"):
        sched.encode_parity(np.zeros((10, 8), np.uint8))
    again = dispatch.scheduler_for(coder)
    assert again is not sched and not again.closed
    again.close()
    again.close()  # idempotent


def test_idle_flusher_exits_by_itself(monkeypatch):
    monkeypatch.setattr(dispatch, "_IDLE_EXIT_S", 0.05)
    sched = dispatch.EcDispatchScheduler(RSCodecCPU(10, 4), window=0.001)
    np.asarray(sched.encode_parity(np.zeros((10, 8), np.uint8)))
    t = sched._thread
    if t is not None:
        t.join(timeout=5)
        assert not t.is_alive()
    sched.close()


def test_error_propagates_to_every_future():
    class Broken:
        data_shards, parity_shards, total_shards = 10, 4, 14

        def encode_parity(self, data):
            raise IOError("boom")

        def reconstruct_stacked(self, present_ids, stacked,
                                data_only=False, want=None):
            raise IOError("boom")

    sched = dispatch.EcDispatchScheduler(Broken(), window=60.0)
    futs = [sched.encode_parity(np.zeros((10, 16), np.uint8))
            for _ in range(3)]
    futs.append(sched.reconstruct_stacked(tuple(range(10)),
                                          np.zeros((10, 16), np.uint8)))
    sched.flush()
    for f in futs:
        with pytest.raises(IOError, match="boom"):
            f.result(timeout=5)
    sched.close()


def test_dispatch_env_gate(monkeypatch):
    coder = RSCodecCPU(10, 4)
    monkeypatch.setenv("SWFS_EC_DISPATCH", "0")
    assert dispatch.maybe_scheduler(coder) is None
    monkeypatch.setenv("SWFS_EC_DISPATCH", "1")
    sched = dispatch.maybe_scheduler(coder)
    assert sched is dispatch.scheduler_for(coder)
    sched.close()


def test_reconstruct_now_paths_and_trace_attribution(monkeypatch):
    """Scheduler on: the caller's span gets the dispatch attribution.
    Off: the coder's stacked reconstruct, want= included."""
    coder = RSCodecCPU(10, 4)
    data = _rng(6).integers(0, 256, (10, 99), dtype=np.uint8)
    shards = np.concatenate([data, coder.encode_parity(data)])
    pres = tuple(range(1, 11))
    stk = shards[list(pres)]
    with trace.span("degraded-read") as sp:
        mids, rows = dispatch.reconstruct_now(coder, pres, stk,
                                              data_only=True)
    assert tuple(mids) == (0,) and np.array_equal(rows[0], shards[0])
    assert sp.attrs["dispatchBatchSlabs"] == 1
    assert sp.attrs["dispatchChip"] == "-"
    assert sp.attrs["dispatchQueueWaitMs"] >= 0
    assert sp.duration_ms >= 0
    monkeypatch.setenv("SWFS_EC_DISPATCH", "0")
    mids2, rows2 = dispatch.reconstruct_now(coder, pres, stk, data_only=True)
    assert tuple(mids2) == (0,) and np.array_equal(rows2, rows)
    mids3, rows3 = dispatch.reconstruct_now(coder, pres, stk, want=(0,))
    assert tuple(mids3) == (0,) and np.array_equal(rows3, rows)


def test_backend_reason_labels_batches(monkeypatch):
    monkeypatch.delenv("SEAWEEDFS_TORCH_CODER", raising=False)
    explicit = new_coder(backend="cpu")
    assert explicit.backend_reason == "cpu_explicit"
    monkeypatch.setenv("SEAWEEDFS_TORCH_CODER", "cpu")
    assert new_coder().backend_reason == "cpu_env"
    before = stats.EC_DISPATCH_BATCHES.value(lane="encode",
                                             reason="cpu_explicit")
    np.asarray(dispatch.scheduler_for(explicit).encode_parity(
        np.zeros((10, 8), np.uint8)))
    assert stats.EC_DISPATCH_BATCHES.value(
        lane="encode", reason="cpu_explicit") == before + 1
    snap = stats.ec_dispatch_stats()
    assert snap["reasons"]["cpuExplicit"] >= 1
    assert snap["encode"]["slabs"] >= snap["encode"]["batches"] >= 1
    assert "-" in snap["perChip"]
    assert stats.EC_DISPATCH_WINDOW_WAIT.snapshot(lane="encode")["count"] >= 1


# -- the arena ----------------------------------------------------------------


def test_arena_quarantines_unready_outputs():
    class InFlight:
        """An output whose flush the card has not finished."""

        def __init__(self):
            self.ready = False

        def is_ready(self):
            return self.ready

    arena = dispatch.StackArena(max_bufs=4, max_bytes=1 << 20)
    buf = arena.get(4096)
    out = InFlight()
    arena.release(buf, out)
    st = arena.stats()
    assert st["quarantined"] == 1 and st["pooled"] == 0
    fresh = arena.get(4096)
    assert fresh is not buf, "quarantined buffer handed out while in flight"
    arena.release(fresh, None)
    out.ready = True
    again = arena.get(4096)  # the sweep reclaims the quarantined buffer
    back = arena.get(4096)
    assert buf in (again, back)
    arena.close()
    assert arena.stats()["pooled"] == 0


def test_consumed_probe_contract():
    assert dispatch._consumed(None)
    assert dispatch._consumed(np.zeros(3, np.uint8))
    assert dispatch._consumed(torch.zeros(3, dtype=torch.uint8))
    assert dispatch._consumed(dispatch.FlushDone(None))
    assert dispatch.FlushDone.after(torch.zeros(3)).event is None
    # a device tensor without its flush's event proves nothing
    assert not dispatch._consumed(torch.empty(3, device="meta"))
    assert not dispatch._consumed(object())


def test_arena_pool_bounds_and_recycling():
    arena = dispatch.StackArena(max_bufs=2, max_bytes=1 << 20)
    b1 = arena.get(5000)
    assert b1.cap == 8192 and b1.flat.ctypes.data % 4096 == 0
    arena.release(b1, None)
    assert arena.get(6000) is b1  # same bucket: a hit
    bufs = [arena.get(1 << 14) for _ in range(3)]
    for b in bufs:
        arena.release(b, None)
    assert arena.stats()["pooled"] <= 2
    arena.close()


def test_scheduler_recycles_arena_buffers(monkeypatch):
    coder = _coder("sel", monkeypatch)
    sched = dispatch.EcDispatchScheduler(coder, window=60.0)
    rng = _rng(7)
    for _ in range(3):
        slabs = [rng.integers(0, 256, (10, 256), dtype=np.uint8)
                 for _ in range(4)]
        futs = [sched.encode_parity(s) for s in slabs]
        for s, f in zip(slabs, futs):
            assert np.array_equal(np.asarray(f), RefCPU(10, 4)
                                  .encode_parity(s))
    st = sched.arena_stats()
    assert st["quarantined"] == 0 and st["pooled"] >= 1
    sched.close()


# -- the lock witness ---------------------------------------------------------


def test_lock_witness_sees_dispatch_order_without_violations(monkeypatch):
    """A concurrent encode under SWFS_LOCK_WITNESS=1 (armed for the test
    suite by tests/conftest.py) leaves the port's witness with no
    violation and with the edge dispatch.mu -> dispatch.lane_cv."""
    assert locks.witness_enabled()
    coder = _coder("sel", monkeypatch)
    sched = dispatch.EcDispatchScheduler(coder, window=0.002)
    assert isinstance(sched._dispatch_mu, locks.WitnessLock)
    rng = _rng(8)
    slabs = [[rng.integers(0, 256, (10, 128), dtype=np.uint8)
              for _ in range(6)] for _ in range(4)]
    errors = []

    def pipeline(mine):
        try:
            futs = [sched.encode_parity(s) for s in mine]
            for s, f in zip(mine, futs):
                assert np.array_equal(np.asarray(f),
                                      RefCPU(10, 4).encode_parity(s))
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=pipeline, args=(s,)) for s in slabs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    sched.close()
    assert locks.violations() == []
    assert "dispatch.lane_cv" in locks.observed_edges().get("dispatch.mu",
                                                            set())


# -- the EC lifecycle of concurrent volumes -----------------------------------


def _make_volume(base: str, seed: int, n_needles: int = 30) -> list:
    """.dat of an 8-byte superblock then padded opaque needle records, and
    its .idx (tests/test_ec_pipeline.py's synthetic volume)."""
    rng = np.random.default_rng(seed)
    dat = bytearray(b"\x03" + bytes(7))
    entries = []
    for i in range(1, n_needles + 1):
        size = int(rng.integers(1, 4000))
        offset = len(dat)
        dat += rng.integers(0, 256, types.actual_size(size)).astype(
            np.uint8).tobytes()
        entries.append((i, offset, size))
    with open(base + ".dat", "wb") as f:
        f.write(bytes(dat))
    ids = np.array([e[0] for e in entries], np.uint64)
    offs = np.array([types.offset_to_stored(e[1]) for e in entries],
                    np.uint32)
    sizes = np.array([e[2] for e in entries], np.int32)
    with open(base + ".idx", "wb") as f:
        f.write(idx.pack_index_arrays(ids, offs, sizes))
    return entries


def _hashes(base: str) -> list[str]:
    out = []
    for i in range(14):
        with open(f"{base}.ec{i:02d}", "rb") as f:
            out.append(hashlib.sha256(f.read()).hexdigest())
    return out


def _all(fn, items) -> list:
    """fn(item) for every item, one thread each, all at once; results in
    order, the first error raised."""
    results = [None] * len(items)
    errors = []

    def run(i, item):
        try:
            results[i] = fn(item)
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, it))
               for i, it in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return results


def test_concurrent_volumes_through_the_scheduler_match_jax(tmp_path,
                                                             monkeypatch):
    """Four volumes encoded at once through one port coder (the sel
    formulation, so K3's plain version runs) with the scheduler on: their
    .ec00-.ec13 equal the JAX package's write_ec_files with the scheduler
    off, and so do the concurrent rebuild of shards {0, 5, 13} and the
    concurrent degraded reads with shard 3 gone (reconstruct_now, K1's
    form); encode slabs really shared launches."""
    n = 4
    ref_geo = RefGeometry(large_block=LARGE, small_block=SMALL)
    geo = Geometry(large_block=LARGE, small_block=SMALL)
    bases, entries = [], []
    for v in range(n):
        os.makedirs(tmp_path / f"ref{v}")
        os.makedirs(tmp_path / f"port{v}")
        for side in ("ref", "port"):
            got = _make_volume(str(tmp_path / f"{side}{v}" / "1"), seed=v)
        bases.append(str(tmp_path / f"port{v}" / "1"))
        entries.append(got)

    # the reference, one volume at a time, scheduler off
    monkeypatch.setenv("SWFS_EC_DISPATCH", "0")
    ref_coder = RSCodecJax(10, 4)
    want = []
    for v in range(n):
        rb = str(tmp_path / f"ref{v}" / "1")
        ref_ec_files.write_ec_files(rb, ref_coder, ref_geo)
        ref_ec_files.write_sorted_file_from_idx(rb)
        encoded = _hashes(rb)
        for i in LOST:
            os.remove(f"{rb}.ec{i:02d}")
        ref_ec_files.rebuild_ec_files(rb, ref_coder, ref_geo)
        assert _hashes(rb) == encoded
        os.remove(f"{rb}.ec{DEGRADED:02d}")
        vol = ref_ec_volume.EcVolume(rb, ref_coder, geo=ref_geo)
        try:
            blobs = [vol.read_needle_blob(nid) for nid, _, _ in entries[v]]
        finally:
            vol.close()
        want.append((encoded, blobs))

    # the port: all volumes at once through one coder, scheduler on
    monkeypatch.setenv("SWFS_EC_DISPATCH", "1")
    monkeypatch.setenv("SWFS_EC_DISPATCH_WINDOW_MS", "20")
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", "sel")
    coder = RSCodecTorch(10, 4, device="cpu")
    calls = {"sel": 0, "xor": 0}
    real_sel, real_xor = rs_sel.gf_matmul_sel, rs_xor.gf_matmul_xor

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(rs_sel, "gf_matmul_sel", count("sel", real_sel))
    monkeypatch.setattr(rs_xor, "gf_matmul_xor", count("xor", real_xor))
    slabs0 = stats.EC_DISPATCH_SLABS.value(lane="encode")
    batches0 = stats.EC_DISPATCH_BATCHES.value(lane="encode")

    def encode(base):
        ec_files.write_ec_files(base, coder, geo)
        ec_files.write_sorted_file_from_idx(base)
        return _hashes(base)

    assert _all(encode, bases) == [w[0] for w in want]
    slabs = stats.EC_DISPATCH_SLABS.value(lane="encode") - slabs0
    batches = stats.EC_DISPATCH_BATCHES.value(lane="encode") - batches0
    assert calls["sel"] == batches and slabs > batches > 0, (slabs, batches)

    def rebuild(base):
        for i in LOST:
            os.remove(f"{base}.ec{i:02d}")
        return ec_files.rebuild_ec_files(base, coder, geo)

    assert _all(rebuild, bases) == [list(LOST)] * n
    assert [_hashes(b) for b in bases] == [w[0] for w in want]

    def degraded(base):
        os.remove(f"{base}.ec{DEGRADED:02d}")
        vol = ec_volume.EcVolume(base, coder, geo=geo)
        try:
            v = bases.index(base)
            return [vol.read_needle_blob(nid) for nid, _, _ in entries[v]]
        finally:
            vol.close()

    sel_before = calls["sel"]
    assert _all(degraded, bases) == [w[1] for w in want]
    assert calls["sel"] == sel_before and calls["xor"] > 0


def test_numa_pinning_gate(monkeypatch):
    """utils/numa.py is a no-op with its gate closed (the default); opened,
    a thread is pinned to one node's CPUs or degrades to a counted no-op."""
    from seaweedfs_tpu.utils import numa as ref_numa
    from seaweedfs_tpu_torch.utils import numa

    monkeypatch.delenv("SWFS_EC_DISPATCH_PIN", raising=False)
    assert numa.pin_thread() is None
    assert not numa.pinning_stats()["enabled"]
    text = "0-3,8,10-11"
    assert numa._parse_cpulist(text) == ref_numa._parse_cpulist(text) == \
        [0, 1, 2, 3, 8, 10, 11]
    monkeypatch.setenv("SWFS_EC_DISPATCH_PIN", "1")
    got = []
    t = threading.Thread(target=lambda: got.append(numa.pin_thread()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert got[0] is None or list(got[0]) in numa.node_cpus()
    assert numa.pinning_stats()["enabled"]


def test_trace_spans_nest_mark_errors_and_gate(monkeypatch):
    monkeypatch.delenv("SWFS_TRACE", raising=False)
    with trace.span("outer", a=1) as outer:
        with trace.span("inner") as inner:
            assert trace.current() is inner
        assert trace.current() is outer
    assert trace.current() is None
    assert inner.trace_id == outer.trace_id
    assert inner.parent_id == outer.span_id and outer.parent_id == ""
    assert outer.attrs == {"a": 1} and outer.duration_ms >= 0
    with pytest.raises(ValueError):
        with trace.span("bad") as bad:
            raise ValueError("x")
    assert bad.error == "ValueError: x"
    monkeypatch.setenv("SWFS_TRACE", "0")
    with trace.span("off") as off:
        off.set_attr(ignored=True)
        assert trace.current() is None
