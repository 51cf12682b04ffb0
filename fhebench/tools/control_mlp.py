"""Read the MNIST inference cell's control (fhebench/reference/
control_mlp.py) at the cell's own size on the given seeds, beside the
limits the check holds the forward to.

    python3 -m fhebench.tools.control_mlp --workload ckks_n15_mlp.mnist --seeds 1,2,3
"""

from __future__ import annotations

import argparse
import json
import sys

from fhebench import harness, inputs
from fhebench.reference import control_mlp, mlp

NUMBERS = ("max_err", "mean_err")  # the control reads the same on both


def reading(cfg: dict, mix: dict, cell: dict, seed: int) -> list[tuple[str, float, float]]:
    """[(number, the control's reading, the limit)] of one seed, over the
    first `sample` images of the pool (as many as a check judges)."""
    layers, xs = mlp.draw(inputs.stream(seed, "messages"), mix["layers"], mix["pool"])
    value = control_mlp.reading(layers, xs[: mix["sample"]])
    return [(name, value, cell["limits"][name]) for name in NUMBERS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cfg, mix, cell = harness.cell_files(harness.workload(harness.manifest(), args.workload))
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        rows = reading(cfg, mix, cell, seed)
        fails = any(value > limit for _, value, limit in rows)
        failed_all &= fails
        print(json.dumps({"workload": args.workload, "seed": seed, "control": str(
            control_mlp.DTYPE), "readings": {n: {"value": v, "limit": lim} for n, v, lim in rows},
            "fails": fails}))
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
