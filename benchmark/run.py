#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port (``d3il_tpu_torch``).

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for. Prints one JSON object as the last line of standard output, and the
numbers of the check beside their limits as the last lines of standard
error. Exits 3 without a CUDA device, 4 if a module of JAX or of the JAX
package is loaded once the window has closed, 2 for an unknown cell.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache inside the checkout, at fixed paths; the port builds its
    # kernels into build/d3il_tpu_torch/ there by itself
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        result, lines = harness.run(args.workload, args.seed, args.seconds,
                                    bool(args.trace), T_START, log)
    except harness.NoCard as e:
        log(f"no card: {e}")
        return 3
    except KeyError as e:
        log(f"unknown cell: {e}")
        return 2
    bad = harness.forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {bad}")
        return 4
    for name, value, limit in lines:
        log(f"check {name} {value!r} "
            + ("not compared" if limit is None else f"limit {limit!r}"))
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
