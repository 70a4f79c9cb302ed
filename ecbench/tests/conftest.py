"""Tests of the benchmark itself: `python3 -m pytest ecbench/tests`.

The tests that need a CUDA card carry the `cuda` marker and skip, from a
fixture, where there is none."""

import json
import shutil
from pathlib import Path

import pytest

from ecbench import registry

TINY_CONFIG = {
    "name": "tiny_rs10_4", "data_shards": 10, "parity_shards": 4,
    # a 64 KiB large row, then 4 KiB small rows: a 1 MiB volume walks both
    "large_block_bytes": 65536, "small_block_bytes": 4096,
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skipped where there is none)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")


def tiny_registry(tmp_path: Path, cells: dict[str, dict],
                  configs: dict[str, dict] | None = None
                  ) -> registry.Registry:
    """A registry whose BENCHMARK.json is the repository's with `cells`
    ({name: traffic}) added, each on its own config (`configs`, default a
    tiny RS(10,4)); files it adds go under tmp_path, the rest is found in
    the package."""
    root = tmp_path / "ecbench"
    (root / "workloads").mkdir(parents=True)
    (root / "configs").mkdir()
    with open(registry.HERE.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    configs = configs or {"tiny_rs10_4": TINY_CONFIG}
    for name, conf in configs.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"ecbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    for name, traffic in cells.items():
        traffic = dict(traffic)
        config = traffic.pop("config", next(iter(configs)))
        (root / "workloads" / f"{name}.json").write_text(json.dumps(traffic))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic["traffic"], "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and (m["name"].endswith(traffic["op"])
                                     or m["name"].startswith(traffic["op"])):
                m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return registry.Registry(tmp_path / "BENCHMARK.json", root)


def cpu_coder(geo, dev):
    """The program's host coder: the stand-in for the card's on the CPU."""
    from seaweedfs_tpu_torch.models.coder import new_coder

    return new_coder(geo.data_shards, geo.parity_shards, backend="cpu")


@pytest.fixture
def tiny(tmp_path):
    reg = tiny_registry(tmp_path, {
        "tiny.encode2": {"traffic": "encode2", "op": "encode", "volumes": 2,
                         "volume_mb": 1, "sample_slabs_per_volume": 2},
    })
    yield reg
    shutil.rmtree(tmp_path / "ecbench" / "_run", ignore_errors=True)
