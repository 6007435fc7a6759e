"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload ga3c4.serve --seed 7 --seconds 10 --trace 0

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its configuration
is ``perfbench/configs/<config>.json``, its traffic ``perfbench/traffic/
<traffic>.json`` (whose ``kind`` names the driver in ``perfbench/kinds/``),
its comparison limits ``perfbench/limits/<workload>.json`` and each per-layer
metric a reader ``perfbench/metrics/<metric>.py``.  The last line of
standard output is one JSON object; the numbers that decide ``correct`` are
its last key, ``check``, and the last lines of standard error.  Before
them a serving run gives ``policy_steps_compared``: in how many of the steps
after the window the policy net's outputs were compared
(``perfbench/check.py``).

Exits 3, printing no result, without enough CUDA cards; 4 if a module of
JAX or of the JAX package was loaded; 2 on a bad argument.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# compared by whole top-level name: the port's name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "gym_collision_avoidance_tpu")
# kernel caches at fixed paths inside the checkout, so that only a cell's
# first run there builds; the port's nvcc libraries live in its own build/
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str) -> dict:
    """The cell's manifest entry, configuration, traffic and limits, found by
    name."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; one of {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    return {
        "manifest": manifest, "cell": cell,
        "config": load_json(ROOT / configs[cell["config"]]["file"]),
        "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(BENCH / "limits" / f"{workload}.json"),
    }


def per_layer_metrics(manifest: dict, workload: str) -> list:
    """The per-layer metrics that list this cell."""
    return [m for m in manifest["per_layer"] if workload in m.get("workloads", ())]


def end_to_end_metrics(manifest: dict, workload: str) -> list:
    return [m for m in manifest["end_to_end"] if workload in m.get("workloads", (workload,))]


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``perfbench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             t_start: float = T_START, control: str = "", overrides=None):
    """One run of ``workload``: the result dict that :func:`main` prints.

    ``device`` None means CUDA card 0 (the benchmark's own runs); tests pass
    ``"cpu"``.  ``control`` names a lower-precision control (``"tf32"``) and
    ``overrides`` replaces traffic fields (both for the control and the tests,
    never for the benchmark's runs)."""
    loaded = load_cell(workload)
    traffic = dict(loaded["traffic"], **(overrides or {}))
    kind = importlib.import_module(f"perfbench.kinds.{traffic['kind']}")
    manifest = loaded["manifest"]
    e2e = end_to_end_metrics(manifest, workload)
    layers = per_layer_metrics(manifest, workload) if trace else []
    result = kind.run(config=loaded["config"], traffic=traffic, limits=loaded["limits"],
                      seed=seed, seconds=seconds, trace=trace, device=device,
                      t_start=t_start, control=control)
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    if trace:
        metrics = {}
        for m in layers:
            value = metric_reader(m["name"])(result["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        metrics = {m["name"]: {"value": result["e2e"][m["name"]], "unit": units[m["name"]]}
                   for m in e2e}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": result["device"]}
    if trace:
        line["breakdown"] = result["breakdown"]
    if "policy_steps_compared" in result:
        line["policy_steps_compared"] = result["policy_steps_compared"]
    line["check"] = result["check"]
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    found = forbidden_modules()
    if found:
        print(f"perfbench: refused, loaded before the run: {found}", file=sys.stderr)
        return 4
    for var, sub in CACHES.items():
        path = BENCH / ".cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    # keep libraries that can load JAX by themselves from doing so
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    try:
        chips = load_cell(args.workload)["cell"]["chips"]
    except (KeyError, OSError) as err:
        print(f"perfbench: {err}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: refused, loaded during the run: {found}", file=sys.stderr)
        return 4
    if "policy_steps_compared" in line:
        compared = line["policy_steps_compared"]
        print(f"policy outputs compared in {compared['steps']} of {compared['of']} steps "
              "after the window", file=sys.stderr)
    for name, c in line["check"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct: {line['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
