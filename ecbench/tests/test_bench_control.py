"""The control, and faults planted under the timed path, come out as not
correct: each drives the rest of a run with the harness's look for a card
skipped, at a tiny size on the CPU."""

import pytest

from ecbench import control, harness

from .conftest import cpu_coder

@pytest.mark.parametrize("kind", ["control", "flip", "half"])
def test_a_broken_coder_is_not_correct(tiny, kind):
    res = harness.run("tiny.encode2", 41, 0.4, False, registry=tiny,
                      coder_factory=control.coder_factory(kind, cpu_coder),
                      dev="cpu", require_card=False)
    assert res["correct"] is False
    assert res["failed"] > 0
    assert max(c["value"] for c in res["checks"].values()) > 0


def test_the_programs_coder_is_correct_on_the_same_seed(tiny):
    res = harness.run("tiny.encode2", 41, 0.4, False, registry=tiny,
                      coder_factory=control.coder_factory("program",
                                                          cpu_coder),
                      dev="cpu", require_card=False)
    assert res["correct"] is True


def test_a_missing_slab_is_caught(tiny, monkeypatch):
    """A pipeline that leaves a slab out of its output fails the check."""
    sink = tiny.op("encode").DigestSink
    real = sink.put

    def drop_second_slab(self, shard_id, shard_off, row, nbytes):
        if shard_off == 65536:  # the first small row, after the large row
            return
        real(self, shard_id, shard_off, row, nbytes)

    monkeypatch.setattr(sink, "put", drop_second_slab)
    res = harness.run("tiny.encode2", 41, 0.4, False, registry=tiny,
                      coder_factory=cpu_coder, dev="cpu", require_card=False)
    assert res["correct"] is False
    assert res["checks"]["slabs_missing"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rs6_3.encode8"])
def test_control_on_the_card(cuda_card, cell):
    res = harness.run(cell, 43, 2.0, False,
                      coder_factory=control.coder_factory(
                          "control", harness.default_coder))
    assert res["correct"] is False
