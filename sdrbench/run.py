"""Run one cell of the benchmark once on a CUDA card.

    python3 sdrbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the numbers the reference compared,
each beside its limit, as the last lines of standard error, and one JSON
line as the last line of standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`.  Without a card, or with a module of JAX or of the JAX package
loaded, it prints no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from sdrbench import harness
    try:
        res = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                               T_START)
    except harness.NoCard as e:
        print(f"sdrbench: {e}", file=sys.stderr)
        return 2
    except harness.Forbidden as e:
        print(f"sdrbench: {e}", file=sys.stderr)
        return 3
    bad = harness.forbidden_modules()
    if bad:
        print("sdrbench: modules loaded in this process: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in res["checks"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
