"""The benchmark's command: one run of one cell on the card.

    python3 -m fhebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object) and
each number the check compared, beside its limit, as the last lines of
standard error. Exits non-zero, printing no result, without a CUDA card (or
with fewer than the cell needs) and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from fhebench import harness

    w = harness.workload(harness.manifest(), args.workload)
    if not torch.cuda.is_available():
        print("fhebench: no CUDA card (torch.cuda.is_available() is false); the benchmark "
              "runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w["chips"]:
        print(f"fhebench: {args.workload} needs {w['chips']} CUDA cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    print(f"card: {_card_line()}", file=sys.stderr, flush=True)
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"fhebench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
