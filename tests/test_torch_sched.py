"""The port's compiled XOR-schedule plane (seaweedfs_tpu_torch/ops/rs_sched.py)
and the schedule cache of its models/geometry.py, against the JAX
package's, on the CPU.

Mirrors tests/test_rs_sched.py: the compiler emits the reference's program
for every registered geometry and for seeded random matrices (the same
(op, dst, src) triples, the same CSE registers), and both executors (the
numpy interpreter and the g++-built C++ one) give the dense GF(256)
product's bytes; the golden RS(10,4) shard hashes reproduce through the
schedule; repair schedules equal the reference's for LRC local-group plans
and the RS sorted-first-k decode; the cache evicts at SCHED_CACHE and
compiles once under concurrency; the SWFS_EC_SCHED gate restores the
dense path; the dispatch scheduler's host lanes ride the schedules with
the `reason` of their batches; an lrc_10_2_2 scrub sweep rides them with
no false finding. Every comparison of bytes is exact (tolerance 0)."""

import hashlib
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.models import geometry as ref_gm
from seaweedfs_tpu.ops import rs_sched as ref_sched
from seaweedfs_tpu.ops.rs_cpu import RSCodecCPU as RefCPU
from seaweedfs_tpu_torch.models import geometry as gm
from seaweedfs_tpu_torch.models.coder import new_coder
from seaweedfs_tpu_torch.ops import dispatch, gf256, rs_sched
from seaweedfs_tpu_torch.ops.rs_cpu import RSCodecCPU
from seaweedfs_tpu_torch.utils import stats
from tests.test_golden_identity import GOLDEN_SHARD_SHA256, _fixture

EXECUTORS = ("numpy", "native")


def _matrix(g):
    try:
        return g.parity_matrix()
    except TypeError:  # non-systematic (pm_mbr): the full generator
        return g.generator_matrix()


def _same_program(port, ref) -> None:
    assert (port.n_in, port.n_out, port.n_tmp) == (ref.n_in, ref.n_out,
                                                   ref.n_tmp)
    assert np.array_equal(port.prog, ref.prog)
    assert port.op_counts == ref.op_counts
    for backend in ("numpy", "native"):
        assert port.predicted_cost(backend) == ref.predicted_cost(backend)
        assert port.prefer(backend) == ref.prefer(backend)


# -- the compiler ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["lrc_10_2_2", "pm_mbr_6_3_5", "rs_10_4",
                                  "rs_6_3", "rs_12_4"])
def test_every_geometry_compiles_to_the_references_program(name):
    m = _matrix(gm.get(name))
    assert np.array_equal(m, _matrix(ref_gm.get(name)))
    sched = rs_sched.compile_matrix(m)
    _same_program(sched, ref_sched.compile_matrix(m))
    data = np.random.default_rng(len(name)).integers(
        0, 256, (m.shape[1], 4096), dtype=np.uint8)
    want = gf256.gf_matmul(m, data)
    for backend in EXECUTORS:
        assert np.array_equal(sched.execute(data, backend), want), backend


def test_registry_names_compile():
    assert gm.names() == ["lrc_10_2_2", "pm_mbr_6_3_5", "rs_10_4"]


def test_lrc_local_parities_compile_without_xtime():
    sched = rs_sched.compile_matrix(gm.lrc_10_2_2().parity_matrix()[:2])
    assert sched.op_counts["xtime"] == 0
    assert sched.op_counts["xor"] + sched.op_counts["set"] == 10


@pytest.mark.parametrize("backend", EXECUTORS)
def test_golden_shard_hashes_through_the_schedule(backend):
    data = _fixture()
    if backend == "numpy":
        parity = rs_sched.maybe_encode(RSCodecCPU(10, 4), data)
        assert parity is not None  # the numpy cost model picks the schedule
    else:
        parity = gm.encode_schedule(gm.rs(10, 4)).execute(data, "native")
    shards = np.concatenate([data, parity])
    assert [hashlib.sha256(s.tobytes()).hexdigest()
            for s in shards] == GOLDEN_SHARD_SHA256


@pytest.mark.parametrize("seed", range(5))
def test_cse_fuzz_random_matrices(seed):
    """Random dense, sparse and binary matrices: the port's program equals
    the reference's and both executors equal the dense product, across
    the C++ executor's 16 KiB tile boundary."""
    rng = np.random.default_rng(0x17 + seed)
    for trial in range(5):
        n_out = int(rng.integers(1, 8))
        n_in = int(rng.integers(1, 16))
        m = rng.integers(0, 256, size=(n_out, n_in), dtype=np.uint8)
        if trial % 3 == 0:
            m = (m & 1).astype(np.uint8)  # pure-XOR planes, heavy CSE
        if trial % 5 == 0:
            m[int(rng.integers(0, n_out))] = 0  # an all-zero output row
        b = int(rng.integers(1, 40000))
        data = rng.integers(0, 256, size=(n_in, b), dtype=np.uint8)
        sched = rs_sched.compile_matrix(m)
        _same_program(sched, ref_sched.compile_matrix(m))
        want = gf256.gf_matmul(m, data)
        for backend in EXECUTORS:
            assert np.array_equal(sched.execute(data, backend), want)


def test_the_executor_refuses_a_wrong_shape():
    sched = rs_sched.compile_matrix(gf256.parity_matrix(10, 4))
    with pytest.raises(ValueError):
        sched.execute(np.zeros((9, 64), np.uint8))


# -- repair schedules ---------------------------------------------------------------


def test_repair_schedule_of_an_lrc_local_group_plan():
    geom = gm.lrc_10_2_2()
    coder, ref = RSCodecCPU(10, 4, geometry=geom), RefCPU(
        10, 4, geometry=ref_gm.lrc_10_2_2())
    data = np.random.default_rng(21).integers(0, 256, (10, 2048), np.uint8)
    full = np.vstack([data, coder.encode_parity(data)])
    for lost in (2, 7):
        plan = geom.repair_plan((lost,), tuple(i for i in range(14)
                                               if i != lost))
        assert len(plan.reads) == 5
        stacked = full[list(plan.reads)]
        got = rs_sched.maybe_reconstruct(coder, plan.reads, stacked,
                                         want=(lost,))
        want = ref_sched.maybe_reconstruct(ref, plan.reads, stacked,
                                           want=(lost,))
        assert got is not None and got[0] == want[0] == (lost,)
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[1][0], full[lost])
        _same_program(gm.repair_schedule(geom, plan.reads, (lost,)),
                      ref_gm.repair_schedule(ref_gm.lrc_10_2_2(),
                                             plan.reads, (lost,)))


@pytest.mark.parametrize("kw", [{}, {"want": (1, 5)}, {"data_only": True}],
                         ids=["all", "want", "data_only"])
def test_repair_schedule_of_the_rs_first_k_decode(kw):
    coder, ref = RSCodecCPU(10, 4), RefCPU(10, 4)
    data = np.random.default_rng(22).integers(0, 256, (10, 2048), np.uint8)
    full = np.vstack([data, coder.encode_parity(data)])
    present = tuple(i for i in range(14) if i not in (1, 5, 12))
    stacked = full[list(present)]
    got = rs_sched.maybe_reconstruct(coder, present, stacked, **kw)
    want = ref_sched.maybe_reconstruct(ref, present, stacked, **kw)
    assert got is not None
    assert got[0] == tuple(want[0])
    assert np.array_equal(got[1], want[1])
    t_dense, r_dense = coder.reconstruct_stacked(present, stacked, **kw)
    assert got[0] == tuple(t_dense) and np.array_equal(got[1], r_dense)


def test_an_unsolvable_repair_steps_aside_for_the_dense_error():
    coder = RSCodecCPU(10, 4)
    present = tuple(range(5))
    stacked = np.zeros((5, 64), np.uint8)
    before = stats.EC_SCHED_SKIPPED.value(role="reconstruct",
                                          reason="unsupported")
    assert rs_sched.maybe_reconstruct(coder, present, stacked) is None
    assert stats.EC_SCHED_SKIPPED.value(
        role="reconstruct", reason="unsupported") == before + 1
    with pytest.raises(ValueError):
        coder.reconstruct_stacked(present, stacked)


def test_a_device_coder_takes_no_schedule():
    from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch

    coder = RSCodecTorch(10, 4, device="cpu")
    assert rs_sched.backend_kind(coder) is None
    assert rs_sched.maybe_encode(coder, np.zeros((10, 8), np.uint8)) is None
    assert rs_sched.backend_kind(RSCodecCPU(10, 4)) == "numpy"
    assert rs_sched.backend_kind(new_coder(10, 4, backend="native")) == \
        "native"


# -- the schedule cache ---------------------------------------------------------


def test_the_cache_hits_and_evicts_at_its_size(monkeypatch):
    monkeypatch.setattr(gm, "SCHED_CACHE", 2)
    gm._sched_cache_clear()
    geoms = [gm.CodeGeometry(f"sched_lru_{i}", 4, 1,
                             np.full((1, 4), i + 1, np.uint8))
             for i in range(3)]
    c0 = stats.EC_SCHED_CACHE_OPS.value(result="compile")
    h0 = stats.EC_SCHED_CACHE_OPS.value(result="hit")
    e0 = stats.EC_SCHED_CACHE_OPS.value(result="evict")
    first = gm.encode_schedule(geoms[0])
    assert gm.encode_schedule(geoms[0]) is first
    assert stats.EC_SCHED_CACHE_OPS.value(result="hit") == h0 + 1
    gm.encode_schedule(geoms[1])
    gm.encode_schedule(geoms[2])  # capacity 2: evicts geoms[0]'s entry
    assert gm.sched_cache_len() == 2
    assert stats.EC_SCHED_CACHE_OPS.value(result="evict") == e0 + 1
    assert gm.encode_schedule(geoms[0]) is not first
    assert stats.EC_SCHED_CACHE_OPS.value(result="compile") == c0 + 4
    assert gm.SCHED_CACHE == 2
    monkeypatch.undo()
    assert gm.SCHED_CACHE == 256  # the reference's default
    gm._sched_cache_clear()


def test_the_cache_compiles_once_under_concurrency(monkeypatch):
    geom = gm.CodeGeometry("sched_once", 4, 2,
                           np.array([[1, 1, 1, 1], [1, 2, 3, 4]], np.uint8))
    calls: list[int] = []
    real = rs_sched.compile_matrix

    def slow_compile(m):
        calls.append(1)
        time.sleep(0.05)
        return real(m)

    monkeypatch.setattr(rs_sched, "compile_matrix", slow_compile)
    gm._sched_cache_clear()
    w0 = stats.EC_SCHED_CACHE_OPS.value(result="wait")
    results: list = []
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        results.append(gm.encode_schedule(geom))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1
    assert len(results) == 8 and all(r is results[0] for r in results)
    assert stats.EC_SCHED_CACHE_OPS.value(result="wait") > w0


def test_a_failed_compile_releases_its_key():
    geom = RSCodecCPU(10, 4).geometry
    for _ in range(2):  # the second call must not wait on the first's key
        with pytest.raises(gm.UnsolvableError):
            gm.repair_schedule(geom, tuple(range(5)), (9,))


# -- the gate and the dispatch lanes ------------------------------------------------


def test_the_gate_off_restores_the_dense_path(monkeypatch):
    monkeypatch.setenv("SWFS_EC_SCHED", "0")
    coder = RSCodecCPU(10, 4)
    data = np.random.default_rng(23).integers(0, 256, (10, 1024), np.uint8)
    s0 = stats.EC_SCHED_SKIPPED.value(role="encode", reason="gate_off")
    assert rs_sched.maybe_encode(coder, data) is None
    assert stats.EC_SCHED_SKIPPED.value(
        role="encode", reason="gate_off") == s0 + 1
    full = np.vstack([data, coder.encode_parity(data)])
    assert rs_sched.maybe_reconstruct(coder, tuple(range(10)), full[:10],
                                      want=(12,)) is None
    e0 = stats.EC_SCHED_BATCHES.value(role="encode")
    sched = dispatch.EcDispatchScheduler(coder)
    try:
        assert np.array_equal(sched.encode_parity(data).result(), full[10:])
    finally:
        sched.close()
    assert stats.EC_SCHED_BATCHES.value(role="encode") == e0


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_host_lanes_ride_the_schedule_with_their_reason(backend):
    coder = new_coder(10, 4, backend=backend, geometry="lrc_10_2_2")
    assert coder.backend_reason == "cpu_explicit"
    ref = RefCPU(10, 4, geometry=ref_gm.lrc_10_2_2())
    sched = dispatch.EcDispatchScheduler(coder)
    data = np.random.default_rng(24).integers(0, 256, (10, 3000), np.uint8)
    kind = "numpy" if backend == "cpu" else "native"
    # the cost model decides, as the reference's does for the same matrix
    takes = gm.encode_schedule(coder.geometry).prefer(kind)
    assert takes == ref_gm.encode_schedule(ref.geometry).prefer(kind)
    e0 = stats.EC_SCHED_BATCHES.value(role="encode", backend=kind)
    k0 = stats.EC_SCHED_SKIPPED.value(role="encode", reason="dense_cheaper")
    r0 = stats.EC_SCHED_BATCHES.value(role="reconstruct")
    d0 = stats.EC_DISPATCH_BATCHES.value(reason="cpu_explicit")
    try:
        parity = sched.encode_parity(data).result()
        assert np.array_equal(parity, ref.encode_parity(data))
        full = np.vstack([data, parity])
        present = tuple(i for i in range(14) if i not in (3, 11))
        missing, rows = sched.reconstruct_stacked(
            present, full[list(present)]).result()
        t_ref, r_ref = ref.reconstruct_stacked(present, full[list(present)])
        assert tuple(missing) == tuple(t_ref)
        assert np.array_equal(rows, r_ref)
    finally:
        sched.close()
    if takes:
        assert stats.EC_SCHED_BATCHES.value(role="encode",
                                            backend=kind) > e0
    else:  # native's vpshufb product beats the schedule of the globals
        assert stats.EC_SCHED_SKIPPED.value(
            role="encode", reason="dense_cheaper") > k0
    if backend == "cpu":
        assert stats.EC_SCHED_BATCHES.value(role="reconstruct") > r0
    assert stats.EC_DISPATCH_BATCHES.value(reason="cpu_explicit") >= d0 + 2


def test_an_env_pinned_coder_says_cpu_env(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TORCH_CODER", "cpu")
    assert new_coder(10, 4).backend_reason == "cpu_env"
    monkeypatch.setenv("SEAWEEDFS_TORCH_CODER", "native")
    assert new_coder(10, 4).backend_reason == "cpu_env"


def test_status_has_the_sched_and_reason_sections():
    out = stats.ec_dispatch_stats()
    assert set(out["sched"]) == {"encode", "reconstruct", "cache"}
    for role in ("encode", "reconstruct"):
        assert {"batches", "bytes", "skipped",
                "coverage"} <= set(out["sched"][role])
    assert {"hit", "compile", "evict", "wait"} == set(out["sched"]["cache"])
    assert isinstance(out["reasons"], dict)


def test_an_lrc_scrub_sweep_rides_the_schedule_with_no_finding(tmp_path):
    from seaweedfs_tpu_torch.scrub.scrubber import Scrubber
    from seaweedfs_tpu_torch.storage.ec_files import (
        write_ec_files,
        write_sorted_file_from_idx,
    )
    from seaweedfs_tpu_torch.storage.ec_locate import Geometry
    from seaweedfs_tpu_torch.storage.ec_volume import save_volume_info
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    geo = Geometry(large_block=10000, small_block=100, code="lrc_10_2_2")
    coder = new_coder(10, 4, backend="cpu", geometry="lrc_10_2_2")
    st = Store([str(tmp_path)], coder=coder)
    v = st.add_volume(1)
    rng = np.random.default_rng(25)
    for i in range(1, 21):
        blob = rng.integers(0, 256, size=int(rng.integers(100, 900)),
                            dtype=np.uint8).tobytes()
        v.write_needle(Needle.create(i, 0xABC, blob))
    base = v.file_name()
    with v._lock:
        v._sync_buffers()
    write_ec_files(base, coder, geo)
    write_sorted_file_from_idx(base)
    save_volume_info(base, {
        "version": v.version, "dataShards": geo.data_shards,
        "parityShards": geo.parity_shards,
        "largeBlock": geo.large_block, "smallBlock": geo.small_block,
        "geometry": "lrc_10_2_2"})
    st.unmount_volume(v.id)
    st.mount_ec_shards(v.id, "", list(range(geo.total_shards)))
    before = stats.EC_SCHED_BATCHES.value(role="encode")
    report = Scrubber(st, None, interval_s=0, max_mbps=0).run_once(full=True)
    assert report.findings == [], [f.detail for f in report.findings]
    assert stats.EC_SCHED_BATCHES.value(role="encode") > before
    st.close()
