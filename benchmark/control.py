#!/usr/bin/env python3
"""The check's readings on the card: the program against the frozen
reference, and the control against it, on several seeds in one process.

    python benchmark/control.py --workload <cell> --seeds 11 12 13 --seconds 30

For each seed: the cell's set-up and a window of ``--seconds`` at the
cell's own batch and mix, long enough to reach the mix's ``check_steps``,
so that the records checked are those a run checks. Then the check's
numbers: the program's outputs against the reference (the readings that
set a limit's lower end), and each control's against it (the upper end):
``bf16``, the reference in the program's place with its state, inputs and
outputs held in bfloat16 (the control), and ``ulp``, the reference stepped
from the program's state moved by one ulp (the witness of what any two
float32 evaluations of a step can differ by).
One JSON line per seed on standard output; ``--out`` also appends them to
a file.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    sys.path.insert(0, str(ROOT))
    from benchmark import cell as cellmod
    from benchmark import harness
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", nargs="*", default=["bf16", "ulp"],
                    choices=sorted(harness.CONTROLS),
                    help="controls to read (none: the program alone)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = cellmod.load_cell(args.workload)
    log(f"card: {harness.card(cell.chips)}")
    for seed in args.seeds:
        t = time.perf_counter()
        sess = harness.Session(cell, seed)
        sess.warm()
        n, dt, _, records = sess.window(args.seconds)
        sess.free()
        prog, pdet = harness.check_records(sess, records)
        row = {"workload": args.workload, "seed": seed, "steps": n,
               "window_s": dt, "records": [r["what"] for r in records],
               "program": prog, "program_detail": pdet}
        for c in args.control:
            ctl, cdet = harness.check_records(sess, records, control=c)
            row.update({c: ctl, f"{c}_detail": cdet})
        row["seconds"] = time.perf_counter() - t
        line = json.dumps(row, default=str)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del sess, records
    bad = harness.forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {bad}")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
