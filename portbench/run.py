"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload cusz-nyx.compress --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout, on a machine with the cell's cards.  Prints
detail lines, then the result as one JSON object on the last line of
standard output; the numbers the check compared, each beside its limit,
are the last lines of standard error.  With no card, or fewer than the
cell asks for, it prints no result and exits with 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for `portbench`) and its `src` (the program), in
# place of this script's own folder
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    chips = harness.chips_of(harness.benchmark(), args.workload)
    if chips is None:
        print(f"portbench: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    except harness.Refused as e:
        print(e.code, file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
