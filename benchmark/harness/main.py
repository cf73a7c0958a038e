"""The command line of ``benchmark/run.py``."""

import argparse
import json
import sys


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv, start: float) -> int:
    args = parse(argv)
    import torch

    from benchmark.harness.core import load_cell, run_cell
    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("benchmark: this cell needs {} CUDA device(s); found {}".format(
            chips, torch.cuda.device_count() if torch.cuda.is_available()
            else 0), file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", start)
    if result is None:
        return 3
    for name, check in result["checks"].items():
        print("check {} {!r} limit {!r}".format(name, check["value"],
                                                 check["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
