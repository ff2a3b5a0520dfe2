"""The benchmark of ``tfpose_tpu_torch`` on NVIDIA cards: one run of one
cell.

    python3 posebench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It sets up the cell (scenes drawn from the seed, the program built and
warmed up on the cell's shapes), drives the cell's entry point in a
closed loop for ``--seconds``, checks a sample of the answers against
the plain reference (``reference/``), and prints, as the last line of
its standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` (each compared number beside its limit,
also the last lines of standard error). It exits non-zero and prints no
result without enough CUDA cards, or where a module of JAX or of the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# one host thread for PyTorch's and the BLAS's CPU pools, in this process
# and in the ranks it spawns: the program's host work is one Python
# thread, and idle pool threads on a shared host only add to the spread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    from posebench.lib.cell import process_start_wall

    t_start = process_start_wall()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import json

    import torch

    from posebench.lib import runner, spec

    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"posebench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result, lines, _ = runner.run(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=t_start)
    bad = runner.forbidden_modules()
    if bad:
        print(f"posebench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
