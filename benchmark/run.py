"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (a file of sizes under benchmark/configs/) and its traffic
mix (benchmark/traffic/<traffic>.json, whose "driver" names the generator
under benchmark/drivers/ that reads it). Each per-layer metric is a
reader of its own, benchmark/metrics/<metric>.py. With --trace 0 the run
measures the cell's end-to-end metrics over a window of --seconds; with
--trace 1 it runs a short steady piece of work once on the host clock and
once under the profiler, in memory, and prints the per-layer metrics, the
device's busy time and a breakdown. Either way it
then checks the first steps or answers against the plain reference
(limits in benchmark/limits/<cell>.json) and prints one JSON line last.

A driver, `Driver(cfg, traffic, seed, device, seconds)`, does the cell's
set-up when it is built and has `run(seconds)` -> {end-to-end metric:
value}, `traced()` -> (warm, work), `free()`, `check()` -> {compared
number: reading}, `counts()` -> (attempted, failed) and, optionally,
`phases` ({set-up phase: seconds}); readers see it through `Context`.

A cell with `"chips": n` > 1 runs as n processes, one per card, in one
process group that is up before any driver is built (benchmark/ranks.py):
this process is rank 0 and starts the others. A driver there reads its
rank and the world's size from `torch.distributed`; every rank makes the
same calls in the same order. Rank 0 prints the one result line: its own
end-to-end metrics and `setup_s` (the ranks' start included), the
per-layer metrics of its own trace, the fullest card's peak, each
compared number at its worst over the ranks, `attempted` and `failed`
summed. A rank that fails, hangs or loads JAX ends the run with no result.
A cell on one card runs here alone, with no process group and no child.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax",
             "latent_diffusion_models_for_shape_sdfs_tpu")


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CACHE / "torch_extensions"))
    os.environ.setdefault("LDM_SDF_NATIVE_MC_LIB",
                          str(CACHE / "native" / "libmarching_cubes_c.so"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(name: str) -> tuple:
    """(manifest, workload entry, configuration, traffic) of a cell."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return manifest, cell, cfg, traffic


def metric_reader(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a per-layer metric's reader sees: the cell, its driver, the
    trace of the traced window, and the host clock's seconds of the same
    work run just before without the profiler (`untraced_s`), which the
    profiler's own host time does not lengthen."""

    def __init__(self, cell, cfg, traffic, driver, trace, untraced_s):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.driver, self.trace, self.untraced_s = driver, trace, untraced_s


def e2e_metrics(manifest, cell, e2e: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics from a driver's run and set-up."""
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"]}
    metrics = {}
    for m in manifest["end_to_end"]:
        if m["name"] == "setup_s":
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        elif m["name"] in e2e and cell["name"] in m.get(
                "workloads", [cell["name"]]):
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": units[m["name"]]}
    return metrics


def layer_metrics(manifest, ctx: Context) -> dict:
    """The cell's per-layer metrics that their readers find."""
    metrics = {}
    for m in manifest["per_layer"]:
        if ctx.cell["name"] not in m.get("workloads", [ctx.cell["name"]]):
            continue
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def run(args, device=None) -> dict:
    """One run of a cell; returns the result line's object. `device`
    None asks for the card and fails without one."""
    cache_env()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    manifest, cell, cfg, traffic = load_cell(args.workload)
    if cell["chips"] > 1:
        from benchmark import ranks
        return ranks.run(args, (manifest, cell, cfg, traffic), device,
                         T_START)
    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(
                f"{args.workload} needs {cell['chips']} CUDA device(s); "
                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from benchmark import checks
    drv_mod = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    t_import = time.perf_counter() - T_START
    driver = drv_mod.Driver(cfg, traffic, int(args.seed), device,
                            float(args.seconds))
    print(f"set-up: {t_import:.2f} s to the driver, then "
          + ", ".join(f"{k} {v:.2f} s" for k, v in
                      getattr(driver, "phases", {}).items()),
          file=sys.stderr, flush=True)
    out: dict = {}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell["chips"]}
    if int(args.trace):
        from benchmark import devtrace
        warm, work = driver.traced()
        warm()
        checks.sync(device)
        t0 = time.perf_counter()
        work()
        checks.sync(device)
        untraced_s = time.perf_counter() - t0
        trace = devtrace.profile_window(work, warm)
        ctx = Context(cell, cfg, traffic, driver, trace, untraced_s)
        metrics = layer_metrics(manifest, ctx)
        device_info["busy_s"] = trace.busy_us() / 1e6
        device_info["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(10),
                            "idle_gaps": trace.idle_gaps(10)}
    else:
        setup_s = time.perf_counter() - T_START
        e2e = driver.run(float(args.seconds))
        metrics = e2e_metrics(manifest, cell, e2e, setup_s)
    device_info["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(device) if device.type == "cuda"
        else 0)
    driver.free()
    readings = driver.check()
    limits = checks.load_limits(ROOT, cell["name"])
    correct, rows = checks.judge(readings, limits)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)
    attempted, failed = driver.counts()
    for name, v, lim in rows:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info, **out,
           "checks": {name: {"value": v, "limit": lim}
                      for name, v, lim in rows}}
    return out


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    out = run(args, device)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
