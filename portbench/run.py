"""Run one cell of the benchmark on the card this process is started on.

    python3 -m portbench.run --workload sd21base-train-paper --seed 7 --seconds 30 --trace 0

From the root of a checkout.  Prints the result as the last line of
standard output (one JSON object) and the numbers compared with the
reference, each beside its limit, as the last lines of standard error.
Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), or when JAX or the JAX package was loaded.
`--control 1` puts the reference computed in fp8 in the program's place
(`correct` must then come out false); the driver never passes it.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # Every build and kernel cache at a fixed path inside the checkout (the
    # package's own kernels build into textboost_torch/csrc/build/).
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    import torch

    from portbench import harness

    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    traffic = harness.load_json("traffic", f"{cell['traffic']}.json")
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = harness.Context(
            workload=args.workload, config=harness.load_json("configs", f"{cell['config']}.json"),
            traffic=traffic, limits=harness.load_json("limits", f"{args.workload}.json"),
            seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
            device=torch.device("cuda", 0), tmp=tmp,
            trace_path=os.path.join(HERE, "out", f"trace-{args.workload}-{args.seed}.json"),
            t0=T0, control=bool(args.control))
        outcome = harness.run_cell(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the measured program may not use JAX", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": outcome["memory_peak_bytes"]}
    if args.trace:
        summary = outcome["readings"]["trace"]
        device.update(busy_s=summary["busy_us"] / 1e6, window_s=summary["window_us"] / 1e6)
    line = harness.result_line(bench, ctx, outcome, device)
    for name, value, limit in outcome["checks"]:
        print(f"compared {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
