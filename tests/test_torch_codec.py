"""RSCodecTorch (on the CPU, through the kernels' plain versions) against
the JAX package's RSCodecJax, plus the coder factory and the port's
isolation from JAX.

Inputs are made with numpy from fixed seeds and handed to both packages;
every comparison is exact (tolerance 0)."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops.rs_cpu import RSCodecCPU as RefCPU
from seaweedfs_tpu.ops.rs_jax import RSCodecJax
from seaweedfs_tpu_torch.models.coder import new_coder
from seaweedfs_tpu_torch.ops import rs_bits, rs_xor
from seaweedfs_tpu_torch.ops.rs_cpu import RSCodecCPU
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GEOMS = [(10, 4, None), (6, 3, None), (12, 4, None), (10, 4, "lrc_10_2_2")]
KERNELS = ["xor", "bits"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs beside other
    workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=KERNELS)
def kernel(request, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", request.param)
    return request.param


def _codecs(k, m, geom):
    return (RSCodecTorch(k, m, geometry=geom, device="cpu"),
            RSCodecJax(k, m, geometry=geom))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("k,m,geom", GEOMS)
def test_encode_matches_jax(kernel, k, m, geom):
    port, ref = _codecs(k, m, geom)
    rng = np.random.default_rng(k * 10 + m)
    data = rng.integers(0, 256, size=(k, 1001), dtype=np.uint8)
    parity = port.encode_parity(data)
    assert parity.dtype == torch.uint8 and parity.device.type == "cpu"
    assert np.array_equal(_np(parity), _np(ref.encode_parity(data)))
    assert np.array_equal(_np(port.encode(data)), _np(ref.encode(data)))
    stack = rng.integers(0, 256, size=(3, k, 257), dtype=np.uint8)
    assert np.array_equal(_np(port.encode_parity_stacked(stack)),
                          _np(ref.encode_parity_stacked(stack)))
    shards = _np(port.encode(data))
    assert port.verify(shards) and int(port.parity_probe(shards)) == 0
    shards[k, 17] ^= 0x5A
    assert not port.verify(shards)
    assert int(port.parity_probe(shards)) == \
        int(ref.parity_probe(shards)) != 0


@pytest.mark.parametrize("k,m,geom", GEOMS)
def test_reconstruct_matches_jax(kernel, k, m, geom):
    port, ref = _codecs(k, m, geom)
    total = k + m
    rng = np.random.default_rng(total)
    shards = _np(ref.encode(rng.integers(0, 256, size=(k, 515),
                                         dtype=np.uint8)))
    for lost in [(0,), (total - 1,), (1, total - 2), (0, 2, total - 1)]:
        present = {i: shards[i] for i in range(total) if i not in lost}
        got = port.reconstruct(present)
        want = ref.reconstruct(present)
        assert sorted(got) == sorted(want) == sorted(lost)
        for i in lost:
            assert np.array_equal(_np(got[i]), _np(want[i]))
            assert np.array_equal(_np(got[i]), shards[i])
        gotd = port.reconstruct_data(present)
        wantd = ref.reconstruct_data(present)
        assert sorted(gotd) == sorted(wantd)
        for i in gotd:
            assert np.array_equal(_np(gotd[i]), _np(wantd[i]))
        # list form with None for the lost shards
        as_list = [None if i in lost else shards[i] for i in range(total)]
        assert sorted(port.reconstruct(as_list)) == sorted(lost)


@pytest.mark.parametrize("k,m,geom", GEOMS)
def test_reconstruct_stacked_matches_jax(kernel, k, m, geom):
    port, ref = _codecs(k, m, geom)
    total = k + m
    rng = np.random.default_rng(100 + total)
    shards = _np(ref.encode(rng.integers(0, 256, size=(k, 333),
                                         dtype=np.uint8)))
    lost = (1, 4, total - 1)
    # survivors in a caller order that is not sorted
    present = tuple(sorted((i for i in range(total) if i not in lost),
                           key=lambda i: (i * 7) % total))
    stacked = shards[list(present)]
    for data_only in (False, True):
        gm, grows = port.reconstruct_stacked(present, stacked,
                                             data_only=data_only)
        rm, rrows = ref.reconstruct_stacked(present, stacked,
                                            data_only=data_only)
        assert gm == rm
        assert np.array_equal(_np(grows), _np(rrows))
        for j, i in enumerate(gm):
            assert np.array_equal(_np(grows)[j], shards[i])
    for want in [(lost[0],), (lost[2], lost[0])]:
        gm, grows = port.reconstruct_stacked(present, stacked, want=want)
        rm, rrows = ref.reconstruct_stacked(present, stacked, want=want)
        assert gm == rm == want
        assert np.array_equal(_np(grows), _np(rrows))
    full = tuple(range(total))
    gm, grows = port.reconstruct_stacked(full, shards)
    assert gm == () and tuple(grows.shape) == (0, shards.shape[1])


def test_lrc_minimal_read_repair_matches_jax(kernel):
    """A single loss in an LRC local group repairs from its 5 peers."""
    port, ref = _codecs(10, 4, "lrc_10_2_2")
    rng = np.random.default_rng(22)
    shards = _np(ref.encode(rng.integers(0, 256, size=(10, 640),
                                         dtype=np.uint8)))
    peers = (0, 1, 3, 4, 10)
    gm, grows = port.reconstruct_stacked(peers, shards[list(peers)],
                                         want=(2,))
    rm, rrows = ref.reconstruct_stacked(peers, shards[list(peers)],
                                        want=(2,))
    assert gm == rm == (2,)
    assert np.array_equal(_np(grows)[0], shards[2])
    assert np.array_equal(_np(grows), _np(rrows))


def test_golden_shard_hashes(kernel):
    from tests.test_golden_identity import GOLDEN_SHARD_SHA256, _fixture

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.GOLDEN_SHARD_SHA256 == GOLDEN_SHARD_SHA256
    data = _fixture()
    shards = _np(RSCodecTorch(10, 4, device="cpu").encode(data))
    got = [hashlib.sha256(s.tobytes()).hexdigest() for s in shards]
    assert got == GOLDEN_SHARD_SHA256


def test_cpu_backend_matches_reference_cpu_codec():
    """The port's numpy codec (its `cpu` backend and oracle) is the
    reference's, byte for byte, including the stacked form."""
    port, ref = RSCodecCPU(10, 4), RefCPU(10, 4)
    rng = np.random.default_rng(31)
    data = rng.integers(0, 256, size=(14, 700), dtype=np.uint8)
    shards = ref.encode(data)
    assert np.array_equal(port.encode(data), shards)
    assert port.verify(shards) and not port.verify(data)
    present = tuple(i for i in range(14) if i not in (2, 11))
    gm, grows = port.reconstruct_stacked(present, shards[list(present)])
    rm, rrows = ref.reconstruct_stacked(present, shards[list(present)])
    assert gm == rm and np.array_equal(grows, rrows)
    stack = rng.integers(0, 256, size=(2, 10, 50), dtype=np.uint8)
    assert np.array_equal(port.encode_parity_stacked(stack),
                          ref.encode_parity_stacked(stack))


def test_codec_identity_and_device():
    a = RSCodecTorch(10, 4, device="cpu")
    assert a == RSCodecTorch(10, 4, device="cpu")
    assert hash(a) == hash(RSCodecTorch(10, 4, device="cpu"))
    assert a != RSCodecTorch(10, 4, geometry="lrc_10_2_2", device="cpu")
    assert a != RSCodecTorch(10, 4, device="cuda")
    assert a.geometry_id == "rs_10_4"
    with pytest.raises(ValueError):
        a.encode_parity(np.zeros((9, 8), np.uint8))
    with pytest.raises(ValueError):
        RSCodecTorch(0, 4)
    with pytest.raises(ValueError):
        RSCodecTorch(250, 10)


def test_unknown_kernel_env_rejected(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", "mxu")
    with pytest.raises(ValueError, match="SEAWEEDFS_TORCH_KERNEL"):
        RSCodecTorch(10, 4, device="cpu").encode_parity(
            np.zeros((10, 8), np.uint8))


def test_cuda_codec_construction_is_lazy():
    """Building a CUDA codec touches no CUDA state; only a call that moves
    data to the card can fail, and then it raises."""
    codec = RSCodecTorch(10, 4, device="cuda")
    assert not torch.cuda.is_initialized()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the failing first use is not shown")
    with pytest.raises((RuntimeError, AssertionError)):
        codec.encode_parity(np.zeros((10, 8), np.uint8))
    assert rs_xor.KERNEL.launches == 0 and rs_bits.KERNEL.launches == 0


def test_new_coder_without_a_card_raises(monkeypatch):
    monkeypatch.delenv("SEAWEEDFS_TORCH_CODER", raising=False)
    if torch.cuda.device_count() > 0:
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_coder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_coder(backend="cuda")


def test_new_coder_backends(monkeypatch):
    assert isinstance(new_coder(backend="cpu"), RSCodecCPU)
    lrc = new_coder(10, 4, backend="cpu", geometry="lrc_10_2_2")
    assert lrc.geometry_id == "lrc_10_2_2"
    monkeypatch.setenv("SEAWEEDFS_TORCH_CODER", "cpu")
    assert isinstance(new_coder(), RSCodecCPU)
    with pytest.raises(ValueError, match="unknown erasure coder backend"):
        new_coder(backend="tpu")


_ISOLATION = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import seaweedfs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(seaweedfs_tpu_torch.__path__,
                                               "seaweedfs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # and everything the smoke test imports
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "seaweedfs_tpu"
             or m.startswith("seaweedfs_tpu."))
print(len(names), bad)
assert "jax" not in sys.modules and not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """In a fresh interpreter (tests/conftest.py has already imported JAX
    into this one): every port module and chip_smoke.py's imports load
    neither jax nor any seaweedfs_tpu module."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _ISOLATION, REPO],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 15 and bad.strip() == "[]"
