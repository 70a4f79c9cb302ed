"""Run one cell of the benchmark once and print its result line.

    python3 ecbench/run.py --workload rs10_4.encode8 --seed 7 \
        --seconds 10 --trace 0

(`python3 -m ecbench.run` works too.) Run it from the root of a checkout
on a machine with the CUDA cards the cell asks for. It prints, on
standard error, the window's size, this process's bytes written and,
last, every number the check compared beside its limit; and, as the last
line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`. Without the cards, or with JAX or the JAX package loaded once
the window has closed, it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (0 where /proc says nothing)."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = T0 - _process_age()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    # run as a script: the checkout's root holds both packages
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from ecbench import harness
    from ecbench.device import NoCard

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    except NoCard as e:
        print(f"ecbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"ecbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
