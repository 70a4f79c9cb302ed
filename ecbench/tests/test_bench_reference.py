"""The frozen reference coder against the port's numpy coder (the test
may import the port; the reference may not)."""

import numpy as np
import pytest
import torch

from ecbench import reference
from seaweedfs_tpu_torch.ops import gf256, rs_cpu


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3)])
def test_encode_matches_the_ports_numpy_coder(k, m):
    assert np.array_equal(reference.encode_matrix(k, m),
                          gf256.build_encode_matrix(k, m))
    data = np.random.default_rng(k).integers(0, 256, (k, 4099), np.uint8)
    got = reference.encode(torch.from_numpy(data), k, m).numpy()
    want = np.asarray(rs_cpu.RSCodecCPU(k, m).encode_parity(data))
    assert np.array_equal(got, want)


def test_parity_follows_the_configuration():
    data = torch.randint(0, 256, (6, 100), dtype=torch.uint8)
    conf = {"data_shards": 6, "parity_shards": 3}
    assert torch.equal(reference.parity(data, conf),
                       reference.encode(data, 6, 3))
    with pytest.raises(ValueError):
        reference.parity(data, dict(conf, code="lrc_10_2_2"))


def test_apply_in_chunks_equals_one_pass():
    data = torch.randint(0, 256, (10, 1000), dtype=torch.uint8)
    m = reference.parity_matrix(10, 4)
    assert torch.equal(reference.apply(m, data, chunk=64),
                       reference.apply(m, data))


def test_field_arithmetic():
    assert reference.mul(2, 128) == 0x1D  # x * x^7 = x^8 = 0x1d mod 0x11d
    for a in range(1, 256):
        assert reference.mul(a, reference.inverse(a)) == 1
