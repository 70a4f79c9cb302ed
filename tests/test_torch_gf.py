"""The port's GF(2^8) helpers against the JAX package's: gf256, the code
geometries and the derived kernel operands (seaweedfs_tpu_torch/ops/gfmat.py).

Both sides are numpy on the host; every comparison is exact (GF arithmetic
has no rounding), so the tolerance is zero throughout."""

import itertools

import numpy as np
import pytest

from seaweedfs_tpu.models import geometry as ref_geometry
from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops import rs_jax as ref_rs_jax
from seaweedfs_tpu.ops import rs_xor as ref_rs_xor
from seaweedfs_tpu_torch.models import geometry
from seaweedfs_tpu_torch.ops import gf256, gfmat

GEOMETRIES = ["rs_10_4", "rs_6_3", "rs_12_4", "lrc_10_2_2"]


def _pair(name):
    return geometry.get(name), ref_geometry.get(name)


def test_field_tables_equal():
    assert np.array_equal(gf256.EXP_TABLE, ref_gf256.EXP_TABLE)
    assert np.array_equal(gf256.LOG_TABLE, ref_gf256.LOG_TABLE)
    assert np.array_equal(gf256._mul_table(), ref_gf256._mul_table())
    a = np.arange(256, dtype=np.uint8)
    assert np.array_equal(gf256.gf_mul_vec(a[:, None], a[None, :]),
                          ref_gf256.gf_mul_vec(a[:, None], a[None, :]))
    for x in range(1, 256, 3):
        assert gf256.gf_inv(x) == ref_gf256.gf_inv(x)
        assert gf256.gf_exp(x, 7) == ref_gf256.gf_exp(x, 7)


@pytest.mark.parametrize("name", GEOMETRIES)
def test_geometry_matrices_equal(name):
    port, ref = _pair(name)
    assert (port.name, port.data_shards, port.parity_shards, port.is_rs,
            port.local_groups, port.volume_capable) == \
        (ref.name, ref.data_shards, ref.parity_shards, ref.is_rs,
         ref.local_groups, ref.volume_capable)
    assert np.array_equal(port.parity_matrix(), ref.parity_matrix())
    assert np.array_equal(port.encode_matrix(), ref.encode_matrix())
    if port.is_rs:
        k, m = port.data_shards, port.parity_shards
        assert np.array_equal(gf256.build_encode_matrix(k, m),
                              ref_gf256.build_encode_matrix(k, m))
        assert np.array_equal(gf256.parity_matrix(k, m),
                              ref_gf256.parity_matrix(k, m))


@pytest.mark.parametrize("name", GEOMETRIES)
def test_derived_operands_equal(name):
    port, ref = _pair(name)
    gp = port.parity_matrix()
    bits = gfmat.gf_matrix_to_bits(gp)
    assert bits.dtype == np.int8 and bits.shape == (8 * gp.shape[0],
                                                    8 * gp.shape[1])
    assert np.array_equal(bits, ref_rs_jax.gf_matrix_to_bits(gp))
    coef = gfmat.xor_coefficients(gp)
    assert coef.dtype == np.int32 and coef.shape == gp.shape + (8,)
    assert np.array_equal(coef, ref_rs_xor.xor_coefficients(gp))
    for form in ("bits", "xor"):
        assert np.array_equal(gfmat.geom_parity_op(port, form),
                              ref_rs_jax.geom_parity_op(ref, form))
        if port.is_rs:
            k, m = port.data_shards, port.parity_shards
            assert np.array_equal(gfmat.parity_matrix_op(k, m, form),
                                  ref_rs_jax.parity_matrix_op(k, m, form))
    assert gfmat.geom_parity_key(port) == ref_rs_jax.geom_parity_key(ref)


def test_derived_rejects_unknown_form():
    with pytest.raises(ValueError):
        gfmat.derived("mxu", ("parity", 10, 4), gf256.parity_matrix(10, 4))


@pytest.mark.parametrize("size", [10, 11, 12, 13, 14])
def test_rs_10_4_every_survivor_set(size):
    """Decode, fused and column-permuted repair matrices for every RS(10,4)
    survivor set of `size` shards, plus their derived forms."""
    port, ref = _pair("rs_10_4")
    for present in itertools.combinations(range(14), size):
        missing = tuple(i for i in range(14) if i not in present)
        dec, used = gfmat.decode_matrix_cached(10, 4, present)
        rdec, rused = ref_rs_jax.decode_matrix_cached(10, 4, present)
        assert used == rused and np.array_equal(dec, rdec)
        fm, fused = gfmat.fused_reconstruct_matrix(10, 4, present, missing)
        rfm, rfused = ref_rs_jax.fused_reconstruct_matrix(10, 4, present,
                                                          missing)
        assert fused == rfused and np.array_equal(fm, rfm)
        for limit in (10, 14):
            miss, pm = gfmat.fused_reconstruct_stacked_matrix(
                10, 4, present, limit)
            rmiss, rpm = ref_rs_jax.fused_reconstruct_stacked_matrix(
                10, 4, present, limit)
            assert miss == rmiss and np.array_equal(pm, rpm)
        if missing:
            assert np.array_equal(
                gfmat.derived("xor", ("fdec", 10, 4, present, missing), fm),
                ref_rs_xor.xor_coefficients(rfm))
            assert np.array_equal(
                gfmat.derived("bits", ("fdec", 10, 4, present, missing), fm),
                ref_rs_jax.gf_matrix_to_bits(rfm))
            assert np.array_equal(
                gfmat.geom_stacked_matrix(port, present, missing),
                ref_rs_jax.geom_stacked_matrix(ref, present, missing))


@pytest.mark.parametrize("name", ["rs_6_3", "rs_12_4", "lrc_10_2_2"])
def test_repair_plans_equal(name):
    """Single and double losses: the minimal-read plan (reads + matrix),
    the stacked repair operands and the targets; LRC's unsolvable
    patterns raise on both sides."""
    port, ref = _pair(name)
    n = port.total_shards
    for lost in itertools.chain(itertools.combinations(range(n), 1),
                                itertools.combinations(range(n), 2)):
        present = tuple(i for i in range(n) if i not in lost)
        plan = port.repair_plan(lost, present)
        rplan = ref.repair_plan(lost, present)
        assert plan.want == rplan.want and plan.reads == rplan.reads
        assert np.array_equal(plan.matrix, rplan.matrix)
        for form in ("bits", "xor"):
            assert np.array_equal(
                gfmat.geom_stacked_op(port, present, lost, form),
                ref_rs_jax.geom_stacked_op(ref, present, lost, form))
        for data_only in (False, True):
            assert gfmat.geom_targets_for(port, present, data_only, None) == \
                ref_rs_jax.geom_targets_for(ref, present, data_only, None)
    if name == "lrc_10_2_2":
        solvable = 0
        for lost in itertools.combinations(range(n), 4):
            present = tuple(i for i in range(n) if i not in lost)
            try:
                port.decode_rows(present)
                ok = True
            except geometry.UnsolvableError:
                ok = False
            try:
                ref.decode_rows(present)
                rok = True
            except ref_geometry.UnsolvableError:
                rok = False
            assert ok == rok
            solvable += ok
        assert solvable == 861  # the count tests/test_geometry.py pins


def test_registry_and_resolution():
    assert geometry.names() == ["lrc_10_2_2", "pm_mbr_6_3_5", "rs_10_4"]
    assert geometry.get("rs_6_3") == geometry.rs(6, 3)
    assert geometry.resolve(10, 4) is geometry.rs(10, 4)
    assert geometry.as_geometry(10, 4, "lrc_10_2_2") is geometry.lrc_10_2_2()
    # the product-matrix code is registered, but no coder takes it
    assert geometry.get("pm_mbr_6_3_5") is geometry.pm_mbr(6, 3, 5)
    with pytest.raises(ValueError, match="volume_capable"):
        geometry.as_geometry(12, 18, "pm_mbr_6_3_5")
    with pytest.raises(ValueError):
        geometry.resolve(6, 3, "lrc_10_2_2")
    with pytest.raises(ValueError):
        geometry.as_geometry(12, 4, "rs_10_4")
