#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port (``opengl_raytracer_torch``).

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  It builds the cell's scene, warms up (the kernels are
built into ``build/`` inside the checkout at the first run there), measures
for ``--seconds``, checks the answers of the window (at pixels drawn from
the seed) against the plain reference (``rtbench/reference/``), prints the compared numbers beside
their limits on standard error, and prints one JSON line last on standard
output: the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics from a ``torch.profiler`` trace of the window.  It exits non-zero,
printing no result, without enough CUDA cards, or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache stays inside the checkout
    build = os.path.join(ROOT, "build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(build, sub)
    sys.path.insert(0, ROOT)

    import torch

    from rtbench import harness

    bench = harness.benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; the cells are "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch sees "
              f"{cards}", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    print(f"card: {harness.card_line()}", flush=True)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the process loaded {loaded}: the benchmark measures the "
              f"port alone", file=sys.stderr)
        return 4
    print(f"frames in the window: {result['attempted']}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
