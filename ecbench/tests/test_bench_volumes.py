"""The seeded volumes, and the shard layout the check assumes, against
the port's own index reader and encoder."""

import numpy as np
import pytest

from ecbench import volumes
from seaweedfs_tpu_torch.models.coder import new_coder
from seaweedfs_tpu_torch.storage import ec_files, idx
from seaweedfs_tpu_torch.storage.ec_locate import Geometry


@pytest.mark.parametrize("size", [1 << 20, (1 << 20) + 8 * 1001])
def test_every_seed_gets_the_same_work(size):
    sizes = volumes.needle_sizes(size)
    assert sum(volumes.record_size(s) for s in sizes) == size - 8
    assert all(1 <= s <= volumes.MAX_NEEDLE + 64 for s in sizes)
    a = volumes.index_bytes(size, 1)
    b = volumes.index_bytes(size, 2)
    assert len(a) == len(b) == 16 * len(sizes) and a != b


def test_index_reads_back_with_the_ports_reader(tmp_path):
    base = str(tmp_path / "v")
    volumes.write_volume(base, 1 << 20, 9, "cpu")
    ids, offs, sizes = idx.read_index_file(base + ".idx")
    order = np.argsort(offs)
    ends = offs[order].astype(np.int64) * 8 + [
        volumes.record_size(int(s)) for s in sizes[order]]
    assert offs[order][0] * 8 == 8 and ends[-1] == 1 << 20
    assert np.array_equal(offs[order][1:].astype(np.int64) * 8, ends[:-1])
    assert sorted(ids.tolist()) == list(range(1, len(ids) + 1))


def test_shard_layout_matches_the_ports_encoder(tmp_path):
    k, m, large, small = 10, 4, 65536, 4096
    base = str(tmp_path / "v")
    volumes.write_volume(base, 1 << 20, 3, "cpu")
    geo = Geometry(k, m, large, small)
    ec_files.write_ec_files(base, new_coder(k, m, backend="cpu"), geo)
    img = np.fromfile(base + ".dat", np.uint8)
    want = volumes.data_shards(img, k, large, small)
    for i in range(k):
        got = np.fromfile(geo.shard_file_name(base, i), np.uint8)
        assert np.array_equal(got, want[i])
    total = 0
    off = 0
    for b in volumes.rows(k, large, small, len(img)):
        total += volumes.dat_bytes_in(k, large, small, len(img), off, b)
        off += b
    assert total == len(img)
