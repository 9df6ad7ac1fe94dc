"""The runner: one cell of ``BENCHMARK.json``, found by name, driven by its
files.

* the cell's configuration: ``portbench/configs/<config>.json``;
* its traffic mix: ``portbench/traffic/<traffic>.json``, whose ``driver``
  names the code in ``portbench/drivers/`` that drives it;
* its limits: ``portbench/limits/<workload>.json``;
* each per-layer metric: ``portbench/metrics/<metric>.py``, a ``read(r)``
  that returns the number or None where its trace holds nothing to read.

A run: check the card, set up (build, weights, inputs, the checked first
steps, warm-up: ``setup_s`` counts from the process's start to here), the
measured window of ``--seconds``, with ``--trace 1`` also a traced segment
after it, the peak memory, the program's state freed, then the reference's
check, and the result line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Callable, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "ccd_tpu")  # top-level module names, compared whole
FAULTS = ("unchanged", "teacher_unchanged", "half_batch", "token")


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_files(spec: dict, workload: str) -> dict:
    """The cell's entry and the paths of its files."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return {"cell": cell, "config": os.path.join(ROOT, config["file"]),
            "traffic": os.path.join(HERE, "traffic", cell["traffic"] + ".json"),
            "limits": os.path.join(HERE, "limits", workload + ".json")}


def metric_names(spec: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def load_module(path: str, name: str):
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def load_driver(ctx):
    """The job class of the traffic mix's ``driver`` (``portbench/drivers/``)."""
    name = ctx.mix["driver"]
    return load_module(os.path.join(HERE, "drivers", name + ".py"), "portbench_driver_" + name).Job


def reader(name: str):
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


def merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def banned_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def use_checkout_caches() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def faulty(fault: Optional[str]) -> Callable:
    """Wraps a side's step or decode with a planted fault (for the tests and
    the readings of the limits; never in a benchmark run)."""
    import torch

    def wrap(fn):
        if fault is None:
            return fn
        if fault in ("unchanged", "teacher_unchanged"):
            # a step that returns its state, or its EMA teacher and centre, unchanged
            kept = _state_tensors if fault == "unchanged" else _teacher_tensors

            def step(state, *inputs):
                saved = [t.detach().clone() for t in kept(state)]
                it = state.iteration
                state, metrics = fn(state, *inputs)
                with torch.no_grad():
                    for t, s in zip(kept(state), saved):
                        t.copy_(s)
                if fault == "unchanged":
                    state.iteration = it
                return state, metrics
            return step
        if fault == "half_batch":     # half of the batch left out, the mean over the rest
            def step(state, raws, aux):
                half = raws.shape[1] // 2
                return fn(state, raws[:, :half], aux[:, :half])
            return step
        if fault == "token":          # a served token altered where it is produced
            def decode(model, images, *a, **kw):
                probs = fn(model, images, *a, **kw).clone()
                top = probs[:, 0].argmax(-1)
                probs[:, 0].scatter_(1, top[:, None], 0.0)
                probs[:, 0].scatter_(1, ((top + 1) % probs.shape[-1])[:, None], 1.0)
                return probs
            return decode
        raise ValueError(f"unknown fault {fault!r}")
    return wrap


def _state_tensors(state) -> list:
    models = [getattr(state, k) for k in ("student", "teacher", "model") if hasattr(state, k)]
    out = [t for m in models for t in list(m.parameters()) + list(m.buffers())]
    opt = state.opt_state
    out += list(getattr(opt, "mu", [])) + list(getattr(opt, "nu", [])) \
        + list(getattr(opt, "trace", []))
    if hasattr(state, "center"):
        out.append(state.center)
    return out


def _teacher_tensors(state) -> list:
    return list(state.teacher.parameters()) + list(state.teacher.buffers()) + [state.center]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="the cell's traffic kind on the CPU at the configuration's rehearsal "
                        "sizes: no device, no device metric")
    p.add_argument("--control", action="store_true",
                   help="the reference in bfloat16 with fp8 operands in the program's place")
    p.add_argument("--fault", choices=FAULTS, help="a planted fault in the program's path")
    return p.parse_args(argv)


def make_context(args, files: dict, device, side, control: bool):
    import torch
    with open(files["config"]) as f:
        cfg = json.load(f)
    with open(files["traffic"]) as f:
        mix = json.load(f)
    limits = {}
    if os.path.exists(files["limits"]):
        with open(files["limits"]) as f:
            limits = {k: v["limit"] for k, v in json.load(f)["numbers"].items()}
    if args.rehearse:
        cfg, mix = merged(cfg, cfg.get("rehearsal", {})), merged(mix, mix.get("rehearsal", {}))
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["compute_dtype"]]
    return SimpleNamespace(cfg=cfg, mix=mix, limits=limits, seed=args.seed, device=device,
                           side=side, dtype=torch.bfloat16 if control else dtype, fp8=control,
                           broken=faulty(args.fault))


def main(argv, started: float) -> int:
    args = parse(argv)
    spec = load_spec()
    files = cell_files(spec, args.workload)
    chips = int(files["cell"]["chips"])
    use_checkout_caches()
    import torch
    if args.rehearse:
        if args.trace:
            print("portbench: a traced run needs a card; --rehearse has none", file=sys.stderr)
            return 2
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=sys.stderr)
            return 2
        if chips != 1:
            print("portbench: cells on more than one card are not driven yet", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)

    from portbench import sut, tracing
    side = sut.reference() if args.control else sut.program()
    ctx = make_context(args, files, device, side, args.control)
    job = load_driver(ctx)(ctx)
    job.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - started

    print(json.dumps({"traffic": job.traffic}), flush=True)
    window = job.window(args.seconds)
    traced = tracing.trace(job.traced_segment) if args.trace else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    job.release()
    t_check = time.time()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    numbers = job.check()
    print(f"portbench: images a second in each fifth of the window: {window['profile']}",
          file=sys.stderr)
    print(f"portbench: set-up {setup_s:.1f} s, window {window['elapsed_s']:.1f} s, check "
          f"{time.time() - t_check:.1f} s, program peak {peak / 2**30:.2f} GiB, reference peak "
          f"{torch.cuda.max_memory_allocated(device) / 2**30 if device.type == 'cuda' else 0:.2f}"
          " GiB", file=sys.stderr)

    if args.trace:
        metrics = {}
        reading = SimpleNamespace(trace=traced, window=window, ctx=ctx)
        for m in metric_names(spec, args.workload, "per_layer"):
            value = reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = dict(window["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in metric_names(spec, args.workload, "end_to_end")}

    found = banned_modules()
    if found:
        print(f"portbench: the process holds modules it must not: {found}", file=sys.stderr)
        return 3
    judged = [n for n in numbers if n["limit"] is not None]
    correct = window["failed"] == 0 and all(n["value"] <= n["limit"] for n in judged)
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
               "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "rehearsal", "count": 0, "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = tracing.breakdown(traced)
    for n in numbers:
        if n["limit"] is None:
            print(f"read, not compared: {n['name']} {n['value']!r} ({n['worst']})",
                  file=sys.stderr)
    for n in judged:
        print(f"{n['name']} {n['value']!r} limit {n['limit']!r} ({n['worst']})", file=sys.stderr)
    result["checked"] = {n["name"]: {"value": n["value"], "limit": n["limit"]} for n in judged}
    sys.stdout.flush()
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
