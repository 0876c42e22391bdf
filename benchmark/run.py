#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (imports, CUDA, the kernels' build
where the checkout has none yet, weights and inputs from the seed, the
cell's warm-up) counts as ``setup_s``. Then, with ``--trace 0``, the cell's
loop runs for ``--seconds`` and the cell's end-to-end metrics are
reported; with ``--trace 1`` it runs for ``--seconds`` unprofiled (for the
``mfu`` metrics), then a bounded number of calls three times: unprofiled,
timed by the host clock, for the traced window's length; under
``torch.profiler`` with device activity alone, for the per-layer metrics
and the device's busy time (a pooled cell's count is a whole number of
its pool, so the two runs make the same calls); under the profiler with
host activity too, for the breakdown's idle gaps. Once the window has closed and the
peak memory is read, the program is freed (a training loop first records
three more steps of its warm path) and the check compares what the window
produced with the plain reference; each number compared is printed beside
its limit as the last lines on standard error, and under ``checks`` in the
result.

The last line on standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (``breakdown`` with tracing), then
``checks``. Without a CUDA card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

FORBIDDEN = ("jax", "jaxlib", "flax", "uasr")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None) -> dict:
    """One run of a cell; returns the result's fields. ``device`` "cpu"
    rehearses the harness at a small size (no device metric is read)."""
    import torch

    from benchmark.core import files
    from benchmark.loops.common import sync

    t_start = T_START if t_start is None else t_start
    work = files.workload(name)
    conf = files.config(work["config"])
    loop = files.module("loops", work["loop"]).Loop(conf, work, seed, device)
    check = files.module("checks", work["loop"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    loop.setup()
    sync(device)
    metrics = {"setup_s": time.perf_counter() - t_start}
    out: dict = {"metrics": {}, "device": {}}
    # no collector pauses inside the measured window (as timeit does)
    gc.collect()
    gc.disable()
    try:
        plain = loop.run(seconds)
    finally:
        gc.enable()
    wanted = files.cell_metrics(name, trace)
    if not trace:
        metrics.update(plain["e2e"])
        missing = [m["name"] for m in wanted if m["name"] not in metrics]
        if missing:
            raise KeyError(f"loop {work['loop']!r} gives no {missing}")
        out["metrics"] = {m["name"]: {"value": metrics[m["name"]], "unit": m["unit"]}
                          for m in wanted}
        out["attempted"], out["failed"] = plain["attempted"], plain["failed"]
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        from benchmark.core.readers import Context
        from benchmark.core.trace import WINDOW, Trace

        n = work["traced_calls"]
        # the traced window's wall: its calls, unprofiled, by the host
        # clock, before any profiler has attached to the process
        sync(device)
        t0 = time.perf_counter()
        replay = loop.run(calls=n)
        sync(device)
        wall = time.perf_counter() - t0
        # device activity alone: the per-layer metrics and the busy time
        # (core/trace.py); the CPU rehearsal has no device to trace
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            traced = loop.run(calls=n)
            sync(device)
            profiled = time.perf_counter() - t0
        tr = Trace(prof, wall_s=wall)
        # host and device activity: the breakdown's idle gaps alone
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                hosted = loop.run(calls=n)
                sync(device)
        ctx = Context(tr, traced["calls"], plain, conf, loop.kind)
        for m in wanted:
            v = files.module("metrics", m["name"]).read(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": Trace(prof).idle_gaps()}
        runs = (plain, traced, replay, hosted)
        out["attempted"] = sum(r["attempted"] for r in runs)
        out["failed"] = sum(r["failed"] for r in runs)
        plain["notes"] += (f"; {n} calls: {1e3 * profiled / n:.3f} ms a call profiled, "
                           f"{1e3 * wall / n:.3f} unprofiled, the window "
                           f"{1e3 * plain['wall_s'] / len(plain['calls']):.3f}")
    if cuda:
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": files.cell_chips(name),
                         "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
                         **out["device"]}
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu rehearsal", "count": 1,
                         "memory_peak_bytes": 0, **out["device"]}
    out["notes"] = plain["notes"]
    # a loop whose check compares steps of the warm path records them now,
    # after the peak is read, on the state the window left
    if hasattr(loop, "record"):
        loop.record()
    loop.release()
    readings = check.readings(loop)
    limits = work["limits"]
    out["checks"] = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    out["correct"] = out["failed"] == 0 and all(
        math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out["checks"].values())
    return out


def emit(out: dict) -> None:
    print(f"run: {out['notes']}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": out["device"]}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else str(v["value"]),
                          "limit": v["limit"]} for k, v in out["checks"].items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from benchmark.core import files

    chips = files.cell_chips(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"no result: the run loaded {loaded}", file=sys.stderr)
        return 2
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
