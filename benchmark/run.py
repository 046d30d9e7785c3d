"""The benchmark of mcrt_tpu_torch: one run of one cell on one NVIDIA GPU.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic and check
are found by name from BENCHMARK.json: configs/<config>.json,
traffic/<traffic>.json and workloads/<workload>.json under this folder; the
configuration's "scene" names scenes/<scene>.py, the traffic's "entry"
names entries/<entry>.py, and each metric the cell reports is read by
metrics/<name>.py. The entry sets up the port, warms up, drives it for
`--seconds`, (with --trace 1) profiles one more pass, and checks what the
window produced against the plain reference (reference/); the run prints
one JSON line: the end-to-end metrics with --trace 0, the per-layer metrics
with --trace 1. The process keeps to two of the host's cores (pin_host). It
exits non-zero with no line without enough CUDA devices, and when a module
of JAX or of the JAX package is loaded once the window has closed.
"""
import time

PROCESS_T0 = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "mcrt_tpu")


def process_start() -> float:
    """The process's start on the wall clock (Linux /proc), else this module's
    import."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in
                     pathlib.Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return min(btime + start / ticks, PROCESS_T0)
    except (OSError, ValueError, IndexError, StopIteration):
        return PROCESS_T0


def pin_host():
    """Two cores for the process and every thread it starts (torch's and
    OpenMP's pools size themselves from this set when torch loads), so that
    runs on hosts with other core counts or other load run alike."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpus[2:4] if len(cpus) >= 4 else cpus[:2])


def caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv_compute")
    os.environ["USE_FLAX"] = "0"


def cell_spec(bench: dict, workload: str) -> dict:
    """The workload's entry, configuration, traffic, check and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of {sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    read = lambda p: json.loads(p.read_text())

    def reported(entries):
        return [m for m in entries if workload in m.get("workloads", [workload])]

    return {
        "workload": w,
        "config": read(ROOT / conf["file"]),
        "traffic": read(HERE / "traffic" / f"{w['traffic']}.json"),
        "check": read(HERE / "workloads" / f"{workload}.json"),
        "end_to_end": reported(bench["end_to_end"]),
        "per_layer": reported(bench["per_layer"]),
    }


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def result_line(spec, run, nums, trace: bool, device_info: dict) -> dict:
    """The last line: correct, attempted, failed, metrics, device, (breakdown),
    and last the numbers compared with their limits."""
    limits = spec["check"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    correct = bool(run.images) and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=run.peak_bytes)
    line = {"correct": correct, "attempted": len(run.images), "failed": 0,
            "metrics": metrics, "device": device}
    if trace and run.profile is not None:
        device["busy_s"] = run.profile.busy_s
        device["window_s"] = run.profile.window_s
        line["breakdown"] = {"device_ops": run.profile.top_ops(),
                             "idle_gaps": run.profile.gaps}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t0 = process_start()
    caches()
    spec = cell_spec(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    pin_host()

    import torch

    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    from . import cell

    run, nums = cell.run(spec["config"], spec["traffic"], spec["check"], args.seed,
                         args.seconds, bool(args.trace), "cuda", t0)
    check_s = time.time() - t0 - run.setup_s - run.window_s
    leaked = banned_modules()
    if leaked:
        print(f"benchmark: modules of JAX or of the JAX package are loaded: {leaked}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit": power_limit()}
    line = result_line(spec, run, nums, bool(args.trace), info)
    print(f"benchmark: {args.workload} seed {args.seed}: {len(run.images)} images in "
          f"{run.window_s:.3f} s; set-up {run.setup_s:.3f} s; after the window {check_s:.3f} s; "
          f"card {info['power_limit']}", file=sys.stderr)
    print("benchmark: image walls " + " ".join(f"{im['wall']:.4f}" for im in run.images),
          file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
