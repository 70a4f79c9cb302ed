"""Configurations, cells and metrics are found by name; a cell, its
config and a metric can be added as files and BENCHMARK.json entries."""

import json

import pytest

from ecbench import harness, registry

from .conftest import TINY_CONFIG, cpu_coder, tiny_registry


def test_every_cell_resolves_to_its_files():
    reg = registry.Registry()
    assert reg.cell_names() == ["rs6_3.encode8"]
    for name in reg.cell_names():
        cell = reg.cell(name)
        assert cell.chips == 1
        assert cell.config["name"] == name.split(".")[0]
        assert reg.op(cell.traffic["op"]).Traffic.name == cell.traffic["op"]
        assert callable(reg.module(cell.config["reference"]).parity)


def test_every_metric_has_a_reader_and_every_cell_reports_enough():
    reg = registry.Registry()
    bench = reg.bench
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reg.reader(m["name"]))
    for name in reg.cell_names():
        e2e = {m["name"] for m in reg.metrics_for(name, trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reg.metrics_for(name, trace=True)


def test_config_files_state_what_benchmark_json_says():
    reg = registry.Registry()
    for conf in reg.bench["configs"]:
        with open(registry.HERE.parent / conf["file"]) as f:
            body = json.load(f)
        assert body["source"] == conf["source"]
        assert sorted(body["reduced"]) == sorted(conf["reduced"])


def test_a_dotted_metric_falls_back_to_its_stem_reader():
    reg = registry.Registry()
    assert reg.reader("copy_busy_share.encode") is \
        reg.reader("copy_busy_share.encode")
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such_metric.encode")


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A new config, a new cell and a new per-layer metric, each a file
    plus a BENCHMARK.json entry, are found and run with no code edited."""
    conf = dict(TINY_CONFIG, name="tiny_rs6_3", data_shards=6,
                parity_shards=3)
    reg = tiny_registry(tmp_path, {
        "tiny6.encode3": {"traffic": "encode3", "op": "encode", "volumes": 3,
                          "volume_mb": 1}},
        configs={"tiny_rs6_3": conf})
    (tmp_path / "ecbench" / "metrics").mkdir()
    (tmp_path / "ecbench" / "metrics" / "slabs_per_s.py").write_text(
        "def read(r, variant):\n"
        "    return r.counter('SeaweedFS_ec_dispatch_slabs', lane='encode')"
        " / r.seconds\n")
    reg.bench["per_layer"].append(
        {"name": "slabs_per_s", "unit": "1/s", "better": "higher",
         "source": "program_counter", "layer": "Dispatch scheduler",
         "moves": "encode_busy_GBps", "workloads": ["tiny6.encode3"]})
    assert "tiny6.encode3" in reg.cell_names()
    assert reg.cell("tiny6.encode3").config["data_shards"] == 6
    res = harness.run("tiny6.encode3", 5, 0.5, False, registry=reg,
                      coder_factory=cpu_coder, dev="cpu", require_card=False)
    assert res["correct"] is True
    assert res["metrics"]["setup_s"]["value"] > 0
    rate = next(x for x in res["stderr_lines"] if x.startswith("encode rate"))
    assert float(rate.split(": ")[1].split()[0]) > 0
    # the per-layer metric, found by its name, needs a traced run, which
    # needs a card: its reader is checked against the counters directly
    read = reg.reader("slabs_per_s")
    r = harness.Readings("encode", 2.0, 1, 0.0, [], {}, {
        "SeaweedFS_ec_dispatch_slabs": {(("lane", "encode"),): 10}},
        None, 0, None)
    assert read(r, "") == 5.0


def test_an_op_added_as_a_file_alone_runs(tmp_path):
    """A traffic file may name an op that a file of its own defines."""
    reg = tiny_registry(tmp_path, {
        "tiny.quiet1": {"traffic": "quiet1", "op": "encode_quiet",
                        "volumes": 1, "volume_mb": 1}})
    (tmp_path / "ecbench" / "ops").mkdir()
    (tmp_path / "ecbench" / "ops" / "encode_quiet.py").write_text(
        "from ecbench import registry\n"
        "class Traffic(registry.Registry().op('encode').Traffic):\n"
        "    name = 'encode'\n"
        "    def lines(self, t0):\n"
        "        return ['quiet']\n")
    res = harness.run("tiny.quiet1", 6, 0.5, False, registry=reg,
                      coder_factory=cpu_coder, dev="cpu", require_card=False)
    assert res["correct"] is True and "quiet" in res["stderr_lines"]
