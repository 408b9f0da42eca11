"""Read the numbers that set a cell's limits, on the card at the cell's own
size: the program's over many seeds, the control's, and the planted
faults', each seed in the same process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
        [--control 1] [--faults half_batch,unchanged] [--seconds S]
        [--out PATH]

The benchmark's own runs never run this. Each seed's set-up is the run's
(no measured window); the readings are those `run.py` compares.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=0.0,
                   help="a short window before the check, for cells whose "
                   "answers come from one (serving)")
    p.add_argument("--out", default="")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark import checks, faults, run
    run.cache_env()
    import torch
    _, cell, cfg, traffic = run.load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = {"cell": args.workload, "card": torch.cuda.get_device_name(0),
           "program": {}, "control": {}, "faults": {}}

    def one(seed, control):
        d = mod.Driver(cfg, traffic, seed, dev, args.seconds)
        if args.seconds:
            d.run(args.seconds)
        d.free()
        got = d.check()
        got_detail = getattr(d, "detail", None)
        ctl = d.control() if control else None
        if got_detail is not None:
            print(json.dumps({"seed": seed, "program_detail": got_detail,
                              "control_detail": d.detail if control
                              else None}), flush=True)
        del d
        gc.collect()
        torch.cuda.empty_cache()
        return got, ctl

    for seed in seeds:
        t0 = time.perf_counter()
        got, ctl = one(seed, args.control)
        out["program"][seed] = got
        if ctl is not None:
            out["control"][seed] = ctl
        print(json.dumps({"seed": seed, "program": got, "control": ctl,
                          "s": time.perf_counter() - t0}), flush=True)
    for name in filter(None, args.faults.split(",")):
        out["faults"][name] = {}
        for seed in seeds[:3]:
            with faults.FAULTS[name]():
                got, _ = one(seed, False)
            out["faults"][name][seed] = got
            print(json.dumps({"fault": name, "seed": seed, "reading": got}),
                  flush=True)
    limits = checks.load_limits(ROOT, args.workload)
    for kind in ("program", "control"):
        rows = list(out[kind].values())
        if rows:
            agg = {k: (max if kind == "program" else min)(r[k] for r in rows)
                   for k in rows[0]}
            print(f"{kind} {'max' if kind == 'program' else 'min'}: "
                  f"{json.dumps(agg)}", flush=True)
            verdicts = [checks.judge(r, limits)[0] for r in rows]
            print(f"{kind} correct under the limits: {verdicts}", flush=True)
    if args.out:
        path = ROOT / args.out
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
