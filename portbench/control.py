"""The control of the check: the plain reference put in the program's
place and computed one precision below the one the configuration states
(bfloat16 for its float32).  Every run of a cell with it in place has to
come out not correct; the benchmark's own runs never run it.

    python3 portbench/control.py --workload cusz-nyx.compress \
        --seeds 11 12 13 --seconds 2

runs the cell at its own size, one short window per seed in one process,
and prints each seed's readings as one JSON line.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

#: the nearest precision below each stated one
LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


class Control:
    """The reference in the program's place, one precision lower: encode
    is the reference's compress, decode its reconstruction of the field
    the container was made from."""

    def __init__(self, cell):
        self.ref = cell.reference
        self.params = cell.config["codec_params"]
        self.dtype = LOWER[cell.config["dtype"]]

    def encode(self, x):
        header, payload = self.ref.compress(x, self.params, self.dtype)
        return header, payload, x

    def decode(self, c):
        return self.ref.reconstruct(c[2], self.params, self.dtype)

    @staticmethod
    def stored(c):
        return c

    @staticmethod
    def container(c):
        return c[0], c[1]

    def counters(self):
        return {}

    def reset_counters(self):
        pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 3

    from portbench import harness

    for seed in args.seeds:
        r = harness.run(args.workload, seed, args.seconds, False,
                        program=Control, emit=lambda d: None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
