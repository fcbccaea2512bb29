#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> --control <m>

Builds the cell once, then for each of `--seeds` seeds (from 2**31 + 1 on)
runs one window of `--seconds` as `run.py` does and compares its sampled
answers with the float64 reference (the program's readings); for the first
`--control` seeds it also puts the reference at float32 in the program's
place (the control's readings). Prints one JSON line a seed, then the
largest program reading and the smallest control reading of each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(1, str(HERE.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1)
    args = ap.parse_args()

    import torch

    from pbench import check, scene, spec
    from pbench.window import Runner

    cell = spec.resolve(args.workload)
    device = torch.device("cuda", 0)
    threads = torch.get_num_threads()
    s = scene.build(cell.config, spec.ROOT, args.first_seed)
    runner = Runner(s, cell.traffic, device)
    torch.set_num_threads(1)
    runner.warm_up(args.first_seed)
    prog, ctl = {}, {}
    for j in range(args.seeds):
        seed = args.first_seed + j
        t0 = time.perf_counter()
        torch.set_num_threads(1)
        win = runner.window(args.seconds, seed, False, sync=lambda: torch.cuda.synchronize(device))
        t1 = time.perf_counter()
        torch.set_num_threads(threads)
        numbers, (y0, yf) = check.program_numbers(cell.config, spec.ROOT, cell.traffic, win, seed)
        t2 = time.perf_counter()
        rec = dict(seed=seed, ensembles=len(win.ensembles), lanes=len(y0), window_s=t1 - t0,
                   reference_s=t2 - t1, program=numbers)
        for k, v in numbers.items():
            prog[k] = max(prog.get(k, v), v)
        if j < args.control:
            c = check.control_numbers(cell.config, spec.ROOT, cell.traffic, y0, yf)
            rec.update(control=c, control_s=time.perf_counter() - t2)
            for k, v in c.items():
                ctl[k] = min(ctl.get(k, v), v)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"workload": args.workload, "lower": prog, "control_least": ctl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
