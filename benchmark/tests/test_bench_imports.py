"""Nothing the benchmark's processes load is JAX or the JAX package, by
whole top-level name; nothing under benchmark/ reads the JAX-era bench
script or its details."""

import json
import pathlib
import subprocess
import sys

from conftest import ROOT

PROBE = r"""
import json, sys, types, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/benchmark/tests")
import conftest
from benchmark import run, calibrate, faults, devtrace
from benchmark.reference import decoder
decoder.load_pack = conftest.small_pack(decoder.load_pack)
def load(name):
    m, c, cfg, t = conftest.load_cell(name)
    conftest.shrink(name, cfg, t)
    return m, c, cfg, t
run.load_cell = load
cells = [w["name"] for w in conftest.manifest()["workloads"]]
for name in cells + list(conftest.PARKED):
    run.run(types.SimpleNamespace(workload=name, seed=1, seconds=0.1,
                                  trace=0), torch.device("cpu"))
for m in [m["name"] for m in conftest.manifest()["per_layer"]] + [
        n for _, _, ms in conftest.PARKED.values() for n in ms]:
    run.metric_reader(m)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_processes_load_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": "/tmp",
                              "USE_FLAX": "0"})
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax",
                      "latent_diffusion_models_for_shape_sdfs_tpu"}
    assert "latent_diffusion_models_for_shape_sdfs_torch" in top


def test_forbidden_names_compare_whole(monkeypatch):
    from benchmark import run
    base = run.forbidden_modules()
    fake = type(sys)("x")
    monkeypatch.setitem(sys.modules,
                        "latent_diffusion_models_for_shape_sdfs_tpu_x", fake)
    monkeypatch.setitem(sys.modules, "jaxlibx", fake)
    assert run.forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "jax.numpy", fake)
    assert "jax" in run.forbidden_modules()


def test_nothing_reads_the_jax_bench_files():
    names = ("bench" + ".py", "bench" + "_details.json")
    for path in pathlib.Path(ROOT, "benchmark").rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json", ".sh"):
            text = path.read_text()
            assert not any(n in text for n in names), path
