"""Read the logistic-regression cells' control (fhebench/reference/
control_logreg.py) at the cell's own size on the given seeds, beside the
limit the check holds it to.

    python3 -m fhebench.tools.control_logreg --workload ckks_n16_l30.logreg_idash --seeds 1,2,3
"""

from __future__ import annotations

import argparse
import json
import sys

from fhebench import harness, inputs
from fhebench.reference import control_logreg, logreg

NUMBER = "mean_err"  # the number the control fails; it passes max_err (control_logreg.py)


def reading(cfg: dict, mix: dict, cell: dict, seed: int) -> tuple[str, float, float]:
    """(number, the control's reading, the limit) of one seed, over the pool
    entries a check samples."""
    x, y = logreg.dataset(inputs.stream(seed, "messages"), mix["samples"], mix["features"])
    return (NUMBER, control_logreg.reading(x, y, mix["lr"], mix["sample"]),
            cell["limits"][NUMBER])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cfg, mix, cell = harness.cell_files(harness.workload(harness.manifest(), args.workload))
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        name, value, limit = reading(cfg, mix, cell, seed)
        failed_all &= value > limit
        print(json.dumps({"workload": args.workload, "seed": seed, "control": name,
                          "value": value, "limit": limit, "fails": value > limit}))
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
