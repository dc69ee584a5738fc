"""The readings that a cell's limits are set from, on the card.

    python3 sdrbench/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 1] [--out FILE]

For each seed, in one process: one run of the cell with a short window
(the harness's own, `run_cell`), then the same passes judged twice: by
the reference against the program's records (the program's readings)
and by the reference against the control, the reference itself put in
the program's place in float32 (the control's readings).  Prints one
JSON line a seed, and a last line with, for every compared number, the
largest program reading and the smallest control reading over the seeds.
The benchmark's own runs never run this.
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


def widest(gaps: list) -> dict:
    out = {}
    for g in gaps:
        for k, v in g.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    from sdrbench import harness
    lines, prog_max, ctrl_min = [], {}, {}
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(a.workload, seed, a.seconds, False,
                               t0, control=True)
        prog = widest(res["gaps"])
        ctrl = widest(res["control_gaps"])
        for k, v in prog.items():
            prog_max[k] = max(prog_max.get(k, 0.0), v)
        for k, v in ctrl.items():
            ctrl_min[k] = min(ctrl_min.get(k, float("inf")), v)
        line = dict(workload=a.workload, seed=seed,
                    correct=res["line"]["correct"], program=prog,
                    control=ctrl, card=res["line"].get("card"),
                    pass_s=res["line"]["pass_s"],
                    setup_s=res["line"]["metrics"].get("setup_s"))
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = dict(workload=a.workload, seeds=a.seeds,
                   program_max=prog_max, control_min=ctrl_min)
    print(json.dumps(summary), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
