"""Run one cell several times, one process after another, and report each
metric's median and spread per set (the spread as the benchmark's bounds
are set from it: the distance between the first and third quartiles of
statistics.quantiles(values, n=4), as a share of the median).

    python3 -m fhebench.tools.sets --workload ckks_n16_dw.boot --seeds 11,12,13 \
        --sets 2 --seconds 40 [--trace 1] [--out boot_runs.jsonl]

Every set runs the same seeds, in the order given. Each run's result line
and the end of its standard error go to --out (JSON lines).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "fhebench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    rec = {"workload": workload, "seed": seed, "trace": trace, "rc": proc.returncode,
           "wall_s": time.perf_counter() - t0, "stderr_tail": proc.stderr[-3000:]}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for k in range(args.sets):
        recs = []
        for seed in seeds:
            rec = run_once(args.workload, seed, args.seconds, args.trace)
            rec["set"] = k
            recs.append(rec)
            res = rec.get("result", {})
            print(json.dumps({"set": k, "seed": seed, "rc": rec["rc"], "wall_s": rec["wall_s"],
                              "correct": res.get("correct"), "attempted": res.get("attempted"),
                              "metrics": {m: v["value"] for m, v in res.get("metrics", {}).items()},
                              "checked": res.get("checked")}), flush=True)
            if rec["rc"] != 0:
                print(rec["stderr_tail"], file=sys.stderr, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        sets.append(recs)
    for k, recs in enumerate(sets):
        names = sorted({m for r in recs for m in r.get("result", {}).get("metrics", {})})
        for m in names:
            vals = [r["result"]["metrics"][m]["value"] for r in recs
                    if m in r.get("result", {}).get("metrics", {})]
            print(json.dumps({"set": k, "metric": m, "n": len(vals),
                              "median": statistics.median(vals), "spread": spread(vals),
                              "min": min(vals), "max": max(vals)}), flush=True)
    return 0 if all(r["rc"] == 0 for recs in sets for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
