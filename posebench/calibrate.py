"""Readings for the limits of the correctness comparison (not run by the
benchmark's own runs).

For one cell and a list of seeds, in one process: the program's numbers
(a short run of the cell through ``lib/runner.py``) and the control's:
the reference put in the program's place in the next precision below
the configuration's.

* fp32 configuration (TF32 off): the reference forward with TF32 on,
  and the reference decode with its inputs and post-graph rounded to
  bf16 (the decode is fp32 outside the tensor cores, so its next step
  down is bf16);
* bf16 configuration: the program's own int8 path (``quantize=True``,
  calibrated on the card) in place of the program.

Each line of ``--out`` (JSON) is one seed's numbers, labelled
``program`` or ``control``; a summary goes to standard output.

    python3 posebench/calibrate.py --workload thin432-single \
        --seeds 1 2 3 --seconds 10 --out cal.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_items(cell, device):
    """The control's (scene, maps, humans) over as many images as a run
    compares, drawn from the seed from the pool."""
    import numpy as np
    import torch

    from posebench.entries import _program
    from posebench.lib import check
    from posebench.lib.cell import humans_px
    from posebench.reference import decode as ref_decode

    rng = np.random.default_rng([cell.seed, 2])
    n = min(cell.workload["check_images"], len(cell.pool))
    ids = sorted(int(i) for i in rng.choice(len(cell.pool), n,
                                            replace=False))
    if cell.config["dtype"] == "float32":
        maps = check.reference_maps(cell, ids, device, tf32=True)
        out = []
        for s in ids:
            humans = ref_decode.decode(maps[s], cell.up_h, cell.up_w,
                                       round_to=torch.bfloat16)
            out.append((s, maps[s].cpu().numpy(), humans))
        return out
    from tfpose_tpu_torch.models.quantize import (
        default_calibration_images,
        quantize_network,
    )

    # the program with the configuration's weights, then its int8 path:
    # calibrated on the card on the program's default calibration scenes
    est = _program.estimator(cell)
    quantize_network(est.net, default_calibration_images((cell.w, cell.h)))
    hook = _program.MapsHook(est.net)
    out = []
    b = cell.batch
    for i in range(0, len(ids), b):
        block = ids[i:i + b]
        humans = est.inference_batch([cell.pool[s] for s in block],
                                     upsample_size=cell.config["upsample"])
        maps = hook.maps.float().cpu().numpy()
        out += [(s, maps[j], humans_px(humans[j], cell.up_w, cell.up_h))
                for j, s in enumerate(block)]
    del est, hook
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--out", required=True)
    parser.add_argument("--skip", choices=("program", "control"))
    args = parser.parse_args(argv)

    import torch

    from posebench.lib import check, runner
    from posebench.lib.cell import Cell

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    dev = torch.device("cuda:0")
    rows = []
    with open(args.out, "a") as f:
        for seed in args.seeds:
            if args.skip != "program":
                result, _, numbers = runner.run(args.workload, seed,
                                                args.seconds, False)
                row = {"workload": args.workload, "seed": seed,
                       "side": "program",
                       **numbers,
                       "metrics": {k: v["value"] for k, v in
                                   result["metrics"].items()}}
                rows.append(row)
                f.write(json.dumps(row) + "\n")
                f.flush()
            if args.skip != "control":
                cell = Cell(args.workload, seed, args.seconds, False)
                cell.render()
                items = control_items(cell, dev)
                ids = [s for s, _, _ in items]
                ref = check.reference_maps(cell, ids, dev)
                low = check.low_precision(cell)
                ref_low = None if low is None else check.reference_maps(
                    cell, ids, dev, dtype=low)
                row = {"workload": args.workload, "seed": seed,
                       "side": "control",
                       **check.compare(cell, items, ref, dev, ref_low)}
                rows.append(row)
                f.write(json.dumps(row) + "\n")
                f.flush()
            print(json.dumps(rows[-2:]), flush=True)
    for side in ("program", "control"):
        got = [r for r in rows if r["side"] == side]
        for key in ("maps_gap", "maps_rms_gap", "maps_rms_ratio",
                    "humans_gap"):
            vals = [r[key] for r in got]
            if vals:
                print(f"{side} {key}: min {min(vals)!r} max {max(vals)!r} "
                      f"n {len(vals)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
