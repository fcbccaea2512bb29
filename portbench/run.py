#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (`nyx_tpu_torch/`) and
`data/`. Set-up builds the cell's configuration through the program's
public API and warms it up at full width; the window runs whole ensembles
back to back through the program's Monte Carlo entry for `--seconds`; then
the sampled answers are compared with the plain reference. The last line
of standard output is one JSON object: `correct`, `attempted` and `failed`
lanes, the end-to-end metrics (`--trace 0`) or the per-layer ones (`--trace
1`, which profiles the window's second ensemble), `device`, with `--trace
1` a `breakdown`, and last the numbers compared beside their limits, which
also close standard error. It exits with 3, printing no result, without
the cards the cell asks for, and with 4 if the process has loaded JAX or
the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path.insert(1, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "nyx_tpu")


def loaded_forbidden() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole (`nyx_tpu_torch` is not `nyx_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def execute(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set-up, the window and the check of one run on `device`; the result
    line's object, its `checks` last. On a CPU device (the tests) the card's
    readings are left out."""
    import torch

    from nyx_tpu_torch.dynamics import gravity_pines
    from pbench import check, scene, spec
    from pbench.window import Runner

    cuda = device.type == "cuda"
    # one host thread for the program's set-up and window, so that no
    # intra-op worker competes with the thread that dispatches to the card
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    torch.zeros(1, device=device)  # the device's context
    marks = [("imports and device", time.perf_counter())]
    s = scene.build(cell.config, ROOT, seed)
    runner = Runner(s, cell.traffic, device)
    marks.append(("scene", time.perf_counter()))
    runner.warm_up(seed)
    sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    win = runner.window(seconds, seed, trace, sync=sync,
                        launches=lambda: gravity_pines.pines_accel_cuda.launches)
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    del runner, s
    gc.collect()
    torch.set_num_threads(threads)
    if cuda:
        torch.cuda.empty_cache()

    numbers, _ = check.program_numbers(cell.config, ROOT, cell.traffic, win, seed)
    correct, shown = check.judge(numbers, check.load_limits(cell.limits_path))

    summary = win.trace.summary() if win.trace is not None else None
    run = SimpleNamespace(setup_s=setup_s, window=win, cell=cell, summary=summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": memory_peak,
                   "card": card_line() if cuda else "cpu"}
    if summary is not None:
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    attempted = sum(e.n_runs for e in win.ensembles)
    ok = sum(e.n_ok for e in win.ensembles)
    result = {"correct": bool(correct), "attempted": attempted, "failed": attempted - ok,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    result["checks"] = shown
    ens = [(e.k, round(e.wall_s, 3), e.iterations, e.n_ok) for e in win.ensembles]
    starts = [t_start] + [t for _, t in marks]
    steps = ", ".join(f"{name} {t - t0:.3f} s" for (name, t), t0 in zip(marks, starts))
    print(f"portbench: {cell.name} seed {seed} card {device_info['card']}; setup {setup_s:.3f} s "
          f"({steps}); window {win.seconds:.3f} s; ensembles (k, s, iterations, ok) {ens}",
          file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from pbench import spec

    cell = spec.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                     T_START)
    found = loaded_forbidden()
    if found:
        print(f"portbench: this process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
