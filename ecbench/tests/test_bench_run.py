"""A whole run at a tiny size on the CPU, the program's host coder
standing in for the card's: the last line's shape, and the refusals."""

import io
import json
import os
import subprocess
import sys

from ecbench import harness, registry

from .conftest import cpu_coder

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def _line(result):
    out, err = io.StringIO(), io.StringIO()
    harness.emit(result, out, err)
    return json.loads(out.getvalue().splitlines()[-1]), err.getvalue()


def test_encode_run_prints_the_contracts_line(tiny):
    res = harness.run("tiny.encode2", 2**31 + 17, 0.5, False, registry=tiny,
                      coder_factory=cpu_coder, dev="cpu", require_card=False)
    line, err = _line(res)
    assert all(k in line for k in REQUIRED)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    # the busy-time rate needs the card's trace: without a card it is left
    # out of the line, as a reader that finds nothing to read leaves it
    assert set(line["metrics"]) == {"setup_s"}
    for v in line["metrics"].values():
        assert v["value"] > 0 and v["unit"]
    assert set(line["checks"]) == {"shard_digests_mismatched",
                                   "slabs_missing", "sampled_bytes_mismatched"}
    # the compared numbers are the last lines of stderr, beside their limits
    tail = err.strip().splitlines()[-3:]
    assert all(t.startswith("check ") and t.endswith("(limit 0)")
               for t in tail)
    assert "write_bytes" in err
    assert not (tiny.workdir("tiny.encode2")).exists()


def test_the_sink_hands_its_work_to_the_verifier(tiny):
    """The pipeline's thread only copies or keeps each row; the digests
    are the verifier's, and the run says what each took."""
    res = harness.run("tiny.encode2", 9, 0.5, False, registry=tiny,
                      coder_factory=cpu_coder, dev="cpu", require_card=False)
    lines = res["stderr_lines"]
    sink = next(x for x in lines if x.startswith("the shard sink's time"))
    verifier = next(x for x in lines if x.startswith("the verifier thread"))
    assert float(sink.split(": ")[1].split()[0]) >= 0
    assert float(verifier.split(": ")[1].split()[0]) > 0
    assert res["correct"] is True


def test_the_same_seed_makes_the_same_volumes(tiny):
    import numpy as np

    from ecbench import volumes

    a = volumes.dat_image(1 << 20, volumes.seed_of(2**31 + 3, 0, 0), "cpu")
    b = volumes.dat_image(1 << 20, volumes.seed_of(2**31 + 3, 0, 0), "cpu")
    c = volumes.dat_image(1 << 20, volumes.seed_of(2**31 + 4, 0, 0), "cpu")
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_without_a_card_the_command_prints_no_result():
    root = registry.HERE.parent
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    done = subprocess.run(
        [sys.executable, "ecbench/run.py", "--workload", "rs6_3.encode8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "CUDA" in done.stderr


def test_program_settings_are_refused(tiny, monkeypatch):
    monkeypatch.setenv("SWFS_EC_DISPATCH_WINDOW_MS", "5")
    try:
        harness.run("tiny.encode2", 1, 0.2, False, registry=tiny,
                    coder_factory=cpu_coder, dev="cpu", require_card=False)
    except harness.RunError as e:
        assert "SWFS_EC_DISPATCH_WINDOW_MS" in str(e)
    else:
        raise AssertionError("a program setting in the environment ran")
