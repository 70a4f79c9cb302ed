"""The check's control, and faults planted under the timed path.

    python3 ecbench/control.py --workload rs10_4.encode8 \
        --seeds 11,12,13 --seconds 4 [--coder control|flip|half|program]

runs a cell with another coder in the program's place, once per seed in
one process, and prints the numbers the check compared. `correct` has to
come out false for every coder but `program`:

  control  the plain reference (reference.py) with its arithmetic cut
           from GF(2^8) to GF(2): each coefficient reduced to its low
           bit, so the code XORs where SeaweedFS's multiplies. It breaks
           the guarantees the configuration states: that any m lost
           shards can be rebuilt, and that shards are SeaweedFS's bytes.
  flip     the program's coder with one byte of every product altered
           where it is produced.
  half     the program's coder with the second half of every product's
           columns left out (zero).
  program  the program's own coder (the benchmark's run, for a baseline
           in the same process).

The benchmark's own runs never use this file.
"""

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ecbench import reference  # noqa: E402


def _rows(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(dev)


class ControlCoder:
    """The reference in the program's place, over GF(2)."""

    def __init__(self, geo, dev):
        k, m = geo.data_shards, geo.parity_shards
        self.data_shards, self.parity_shards = k, m
        self.total_shards = k + m
        self.geometry_id = f"rs_{k}_{m}"
        self.dev = torch.device(dev)

    def encode_parity(self, data):
        matrix = reference.parity_matrix(self.data_shards,
                                         self.parity_shards) & 1
        return reference.apply(matrix, _rows(data, self.dev))


def _planted(out, fault: str):
    """`out` (a product, [R, B]) with the fault planted, on the host."""
    host = (out.detach().cpu().numpy() if isinstance(out, torch.Tensor)
            else np.asarray(out, np.uint8)).copy()
    if fault == "flip":
        host[0, host.shape[1] // 2] ^= 0x5A
    elif fault == "half":
        host[:, host.shape[1] // 2:] = 0
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return host


class FaultyCoder:
    """The program's coder with `fault` planted in every product."""

    def __init__(self, inner, fault: str):
        self._inner = inner
        self._fault = fault
        self.data_shards = inner.data_shards
        self.parity_shards = inner.parity_shards
        self.total_shards = inner.total_shards
        self.geometry_id = getattr(inner, "geometry_id",
                                   f"rs_{self.data_shards}_"
                                   f"{self.parity_shards}")

    def encode_parity(self, data):
        return _planted(self._inner.encode_parity(data), self._fault)


def coder_factory(kind: str, program_factory):
    """A harness coder factory for `kind` (see the module's docstring)."""
    if kind == "program":
        return program_factory
    if kind == "control":
        return ControlCoder
    return lambda geo, dev: FaultyCoder(program_factory(geo, dev), kind)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the check's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one run each")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--coder", default="control",
                   choices=("control", "flip", "half", "program"))
    args = p.parse_args(argv)

    from ecbench import harness

    make = coder_factory(args.coder, harness.default_coder)
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run(args.workload, seed, args.seconds, False,
                             coder_factory=make)
        lines = result.pop("stderr_lines")
        print(json.dumps({"workload": args.workload, "coder": args.coder,
                          "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "failed": result["failed"],
                          "metrics": result["metrics"],
                          "checks": result["checks"],
                          "window": lines[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
