"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as `setup_s` from the start of this process, as the kernel
records it: the interpreter, the imports, the card, the inputs, the
state): draw the configuration's cloud and the mix's request pool from the
seed (`traffic.py`), build the entry's state (`entries/`) and run the
warm-up request.  The first run in a checkout also builds the program's
CUDA library into `build/fgoicp_tpu_torch/` there.  Then a closed loop,
one request in flight, replays the pool for `--seconds` seconds; the
window ends at the end of the last request.  After it: the peak memory is
read, the program's state freed, and every answer of the window is held
against the plain reference (`check.py`).

Against host noise the run keeps the CPU side to one thread: the math
libraries' thread pools (set before numpy and torch load) and torch's
intra-op pool.  The last line on standard output
is one JSON object: correct, attempted, failed, metrics, device (and with
--trace 1 breakdown), and last `checks`, each number compared beside its
limit, which are also the last lines on standard error.

--trace 0 reports the cell's end-to-end metrics; --trace 1 its per-layer
metrics: the entry's synchronized spans run through the whole window and
torch.profiler records the mix's `trace_requests` first requests, with the
NN kernels' shapes.  Each metric is the `read(ctx)` of its file in
`metrics/`; a reader that finds nothing returns None and the metric is left
out.

Exit codes: 0 with a result; 2 without a CUDA card, or with fewer than the
cell's chips; 3 when a JAX module (jax, jaxlib, flax, fgoicp_tpu, by whole
top-level name) is loaded once the window has closed; anything else is a
failure of the run.
"""

from __future__ import annotations

import os
import time


def process_start() -> float:
    """The perf_counter() reading at this process's start, from the start
    time the kernel keeps (/proc/self/stat, in clock ticks since boot);
    now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter()


T0 = process_start()
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
for _var in THREAD_VARS:
    os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import check, spec, traffic  # noqa: E402
from portbench import trace as tr  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fgoicp_tpu")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """The JAX modules loaded, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _profiler(torch, cuda):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def run_cell(bench, cell, seed, seconds, trace, device, t0, config=None,
             mix=None):
    """One run of `cell`; returns (result dict, the window's answered
    items, the metrics' context).
    `config` and `mix` default to the files the cell names."""
    import torch
    from torch.profiler import record_function
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()

    config = config or spec.config(cell["config"])
    mix = mix or spec.traffic(cell["traffic"])
    entry = spec.entry(config["entry"])
    work = traffic.build(config, mix, seed)
    state = entry.build(config, work, device)
    entry.call(state, work.warmup)
    sync()
    setup_s = time.perf_counter() - t0

    spans = nn = prof = window = None
    profiled_s = {}
    traced = int(mix["trace_requests"]) if trace else 0
    if trace:
        import fgoicp_tpu_torch.ops.cuda_nn as cuda_nn
        spans = tr.Spans(sync, label=record_function)
        for owner, attr, name in entry.probes():
            spans.install(owner, attr, name)
        nn = tr.NNCalls(cuda_nn)
    before = entry.counters(state)
    done, latencies = [], []
    t_start = t_end = time.perf_counter()
    # At least one request, and in a traced run one after the profiled.
    while len(done) <= traced or time.perf_counter() - t_start < seconds:
        k = len(done) % len(work.pool)
        if len(done) == 0 and traced:
            prof = _profiler(torch, cuda)
            prof.__enter__()
            window = record_function(tr.WINDOW)
            window.__enter__()
            nn.install()
        t_req = time.perf_counter()
        answers = entry.call(state, work.pool[k])
        sync()
        t_end = time.perf_counter()
        latencies.append(t_end - t_req)
        done.append((k, answers))
        if len(done) == traced:
            sync()
            window.__exit__(None, None, None)
            nn.restore()
            prof.__exit__(None, None, None)
            # Spans and counters leave out the profiled requests, whose
            # host time the profiler inflates.
            profiled_s = dict(spans.seconds)
            before = entry.counters(state)
    after = entry.counters(state)
    if spans is not None:
        spans.restore()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    items, attempted = [], 0
    for k, answers in done:
        req = work.pool[k]
        attempted += len(req.sources)
        target = req.target if req.target is not None else work.target
        items += [check.Item(target, src, truth, ans) for src, truth, ans
                  in zip(req.sources, req.truths, answers)]
    correct, checks = check.judge(attempted, items,
                                  float(config["mse_threshold"]),
                                  config["limits"], device)

    ctx = {"setup_s": setup_s, "window_s": t_end - t_start,
           "requests": len(done), "pairs": attempted,
           "latencies": latencies,
           "certified": sum(it.answer.certified and it.answer.finite()
                            for it in items),
           "counters": {key: v - before.get(key, 0)
                        for key, v in after.items()},
           "spans_s": {k: v - profiled_s.get(k, 0.0)
                       for k, v in (spans.seconds if spans else {}).items()},
           "later_requests": len(done) - traced,
           "later_pairs": sum(len(work.pool[k].sources)
                              for k, _ in done[traced:]),
           "profile": None}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name() if cuda
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": attempted - ctx["certified"]}
    if trace:
        profile = tr.reduce(tr.events(prof))
        profile.update(
            requests=traced, nn_calls=nn.calls,
            pairs=sum(len(work.pool[k].sources) for k, _ in done[:traced]))
        ctx["profile"] = profile
        device_info.update(busy_s=profile["busy_s"],
                           window_s=profile["window_s"])
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], kind):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result.update(metrics=metrics, device=device_info)
    if trace:
        result["breakdown"] = {"device_ops": ctx["profile"]["device_ops"],
                               "idle_gaps": ctx["profile"]["idle_gaps"]}
    result["checks"] = checks
    return result, items, ctx


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, _, _ = run_cell(bench, cell, args.seed, args.seconds, args.trace,
                            "cuda", T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX modules loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
