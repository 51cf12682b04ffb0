"""Read each cell's control (fhebench/reference/control.py) at the cell's
own size on the given seeds, beside the limit the check holds it to.

    python3 -m fhebench.tools.control --workload ckks_n16_dw.boot --seeds 1,2,3 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

from fhebench import harness, inputs
from fhebench.reference import control


def reading(cfg: dict, mix: dict, cell: dict, seed: int, device="cpu") -> tuple[str, float, float]:
    """(number, the control's reading, the limit) of one seed."""
    msgs = inputs.messages(mix, cfg["n"], cfg["plain_modulus"], seed)[: mix["sample"]]
    if mix["circuit"] == "bootstrap":
        return "max_err", control.bootstrap(msgs), cell["limits"]["max_err"]
    if mix["circuit"] == "ckks_square_chain":
        return ("max_err", control.ckks_square_chain(msgs, mix["depth"]),
                cell["limits"]["max_err"])
    return ("wrong_coeffs",
            control.integer_square_chain(msgs, cfg["plain_modulus"], mix["depth"], device), 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    cfg, mix, cell = harness.cell_files(harness.workload(harness.manifest(), args.workload))
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        name, value, limit = reading(cfg, mix, cell, seed, args.device)
        failed_all &= value > limit
        print(json.dumps({"workload": args.workload, "seed": seed, "control": name,
                          "value": value, "limit": limit, "fails": value > limit}))
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
