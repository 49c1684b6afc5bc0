"""The benchmark of stylegan_torch on NVIDIA GPUs: one run of one cell.

    python -m gpubench.run --workload NAME --seed N --seconds S --trace 0|1

Set-up (counted in ``setup_s``, from the process's start) builds the
program's kernel library where its cache in the checkout misses, makes
the weights and inputs from the seed on the device, builds the program's
entry and warms every shape the cell uses.  The window then runs the
cell's traffic for S seconds; with ``--trace 1`` a stretch of it is
profiled and the cell's per-layer metrics are reported in place of its
end-to-end ones.  After the window the program is freed and the plain
reference checks what the window's path produced; each number compared is
printed beside its limit, as the last lines on standard error and under
``checks``, the last key of the result, which is the last line of
standard output.  No card, fewer cards than the cell takes, or a JAX
module loaded: no result and a non-zero exit.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (0 where /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

from . import cells, check, counts  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "stylegan_tpu")
BUILD = cells.BENCH.parent / "build" / "gpubench"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


HOST_CORES = 4


def pin_host(cores: int = HOST_CORES) -> list:
    """Keeps the run to the first `cores` CPUs it may use, and PyTorch's
    CPU work to as many threads (one for inter-op work), so that the host
    side of a run meets the same cores and threads each time.  Returns the
    CPUs."""
    import torch
    cpus = sorted(os.sched_getaffinity(0))[:cores]
    os.sched_setaffinity(0, cpus)
    torch.set_num_threads(len(cpus))
    torch.set_num_interop_threads(1)
    return cpus


def banned_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(BANNED))


def execute(cell, seed: int, seconds: float, traced: bool,
            device="cuda", t_start: float = T_START, bench=cells.BENCH,
            ranks=None, hook=None):
    """One run of `cell` through its traffic kind, as rank `ranks` = (this
    rank, the ranks, a host-side group) of a cell on several chips;
    `hook` stands in for the kind's Program (a planted fault).  Returns
    (the result line, what is reported beside it: the set-up's parts and
    the numbers read but not compared)."""
    import torch

    from . import drive, program
    from .trace import Tracer

    device = torch.device(device)
    cuda = device.type == "cuda"
    build_s = program.build_library() if cuda else 0.0
    kind = cells.kind(cell.kind, bench)
    load = kind.Load(hook or kind.Program, cell, seed, device, ranks)
    run = drive.Run(entry=load.family, config=cell.config)
    load.warm()
    if cuda:
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_start
    tracer = None
    if traced:
        a = cell.traffic["trace_from"]
        tracer = Tracer(a, cell.traffic["trace_units"],
                        BUILD / f"{cell.name}.trace")
    load.window(run, seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if tracer is not None:
        run.trace = tracer.close()
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    run.peaks = counts.peaks(name) if cuda else None

    load.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ok, checks, readings = check.verdict(load.numbers(),
                                         cell.workload["limits"])
    check_s = time.perf_counter() - t_check

    spec = cells.benchmark(bench)
    chosen = cells.metrics_for(spec, cell.name, traced)
    if chosen is None:        # a cell BENCHMARK.json does not list
        e2e = [m for m in spec["end_to_end"]
               if cells.reader(m["name"], bench)(run) is not None]
        chosen = e2e if not traced else [
            m for m in spec["per_layer"]
            if m["moves"] in {x["name"] for x in e2e}]
    metrics = {}
    for m in chosen:
        v = cells.reader(m["name"], bench)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(ok and run.failed == 0 and run.units > 0),
            "attempted": run.units, "failed": run.failed,
            "metrics": metrics, "device": dev}
    if traced and run.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["checks"] = checks
    return line, {"library_build_s": build_s, "check_s": check_s,
                  "window_s": run.window_s, **readings}


def _rank_main(rank: int, world: int, port: int, args, start_epoch: float,
               backend: str, queue):
    """One rank of a cell on several chips: rank r on card r, NCCL over
    localhost, a gloo group beside it for the host's stop flag; rank 0
    hands its result to the launcher."""
    import torch
    import torch.distributed as dist
    cuda = backend == "nccl"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        ctl = dist.new_group(backend="gloo")
        cell = cells.load_cell(args.workload, args.bench)
        t_start = time.perf_counter() - (time.time() - start_epoch)
        line, extra = execute(cell, args.seed, args.seconds, False, device,
                              t_start, args.bench, (rank, world, ctl))
        if rank == 0:
            queue.put((line, extra))
    finally:
        dist.destroy_process_group()


def launch(args, world: int, backend: str = "nccl"):
    """Runs the cell's ranks in processes of their own; returns rank 0's
    (line, extra), or raises when a rank failed."""
    import multiprocessing
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    start_epoch = time.time() - (time.perf_counter() - T_START)
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, args,
                                                  start_epoch, backend,
                                                  queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        result = queue.get(timeout=3000)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return result


def main(argv=None) -> int:
    args = parse(argv)
    args.bench = cells.BENCH
    cell = cells.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # every build and kernel cache at a fixed path inside the checkout;
    # NCCL writes nothing to /dev/shm
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BUILD / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
    os.environ.setdefault("NCCL_SHM_DISABLE", "1")
    pin_host(HOST_CORES * cell.chips)
    try:
        if cell.chips > 1:
            from . import program
            program.build_library()     # once, before the ranks start
            line, extra = launch(args, cell.chips)
        else:
            line, extra = execute(cell, args.seed, args.seconds,
                                  bool(args.trace))
    except Exception:   # the run's boundary: report, and print no result
        traceback.print_exc()
        return 1
    found = banned_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    for k, v in extra.items():
        print(f"{k}: {v}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
