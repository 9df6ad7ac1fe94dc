"""The readings that the limits of ``portbench/limits/`` are set from: the
numbers of the check for many seeds in one process, on the program, on the
lower-precision control in its place, or on the program with a planted
fault. Not part of a benchmark run.

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 \
        [--as program|control|unchanged|teacher_unchanged|half_batch|token] [--seconds 4]

prints one JSON line a seed: {"seed", "as", "numbers": {name: value}}.
Training readings need no window; recognition runs a window of
``--seconds`` at the cell's load so that the check has served batches.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]

from portbench import harness, sut  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--as", dest="side", default="program",
                   choices=("program", "control") + harness.FAULTS)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    harness.use_checkout_caches()
    import torch
    spec = harness.load_spec()
    files = harness.cell_files(spec, args.workload)
    device = torch.device("cpu") if args.rehearse else torch.device("cuda", 0)
    control = args.side == "control"
    fault = args.side if args.side in harness.FAULTS else None
    side = sut.reference() if control else sut.program()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        run = argparse.Namespace(seed=seed, rehearse=args.rehearse, fault=fault)
        ctx = harness.make_context(run, files, device, side, control)
        job = harness.load_driver(ctx)(ctx)
        job.setup()
        window = job.window(args.seconds if ctx.mix["driver"] == "eval" else 0.0)
        job.release()
        numbers = job.check()
        print(json.dumps({"seed": seed, "as": args.side, "failed": window["failed"],
                          "numbers": {n["name"]: n["value"] for n in numbers},
                          "worst": {n["name"]: n["worst"] for n in numbers},
                          "seconds": time.time() - t0}), flush=True)
        del job
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
