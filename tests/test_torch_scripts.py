"""The port's tools (`python -m fgoicp_tpu_torch.scripts.<name>`) on the
CPU at tiny sizes:

* make_test_pair: the same PLY bytes and truth TOML as the JAX package's
  scripts/make_test_pair.py for the same input and seed;
* visualize: the static panels render a PNG and the convergence GIF
  renders (matplotlib, skipped without it), from a result TOML and --run;
* kernel_check: the tiny grid runs every kernel's row, plain against
  plain on the CPU, prints one JSON object and writes it to --out only;
  its recorder, on a tiny search-only GoICP, keeps one call a launch shape
  of each kernel, forwards the wrappers' counters, puts the wrappers back
  and holds every shape;
* profile_phases, proxy_sweep: one JSON line a run / size, with the phase
  seconds, ms per ICP iteration and per inner step; a real-scan workload
  without --data is refused;
* scaling_bench: 1 and 2 spawned gloo ranks on the CPU, with the warning
  that shared cores measure the protocol, not scaling;
* none of them imports jax.
"""
import json
import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest

from fgoicp_tpu_torch.io import write_ply
from fgoicp_tpu_torch.scripts import kernel_check, workloads
from test_goicp import _make_problem
from test_torch_goicp import _t_engine, _write_config
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The tiny search every timing tool runs here.
SMALL = ["--device", "cpu", "--scale", "0.03", "--rotation-min-span", "0.1",
         "--translation-min-span", "0.2"]


def _tool(name, *args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"fgoicp_tpu_torch.scripts.{name}", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)
    return proc


def test_make_test_pair_matches_the_jax_script(tmp_path):
    cloud = workloads.bunny_synth(500, 16)[0]
    src = tmp_path / "in.ply"
    write_ply(str(src), cloud)
    outs = {}
    for pkg, cmd in (("jax", [sys.executable, "scripts/make_test_pair.py"]),
                     ("torch", [sys.executable, "-m",
                                "fgoicp_tpu_torch.scripts.make_test_pair"])):
        out, truth = tmp_path / f"{pkg}.ply", tmp_path / f"{pkg}.toml"
        proc = subprocess.run(
            cmd + [str(src), str(out), "--fraction", "0.2", "--seed", "7",
                   "--truth", str(truth)], capture_output=True, text=True,
            timeout=120, cwd=REPO)
        assert proc.returncode == 0, proc.stderr
        outs[pkg] = (out.read_bytes(), truth.read_bytes())
    assert outs["torch"] == outs["jax"]
    truth = tomllib.loads(outs["torch"][1].decode())["truth"]
    assert truth["seed"] == 7 and len(truth["rotation"]) == 3


def test_visualize_renders_panels_and_animation(tmp_path):
    pytest.importorskip("matplotlib")
    from fgoicp_tpu_torch.scripts import visualize
    from test_goicp import _make_problem
    pct, pcs, R_true, t_true = _make_problem(seed=0, angle=2.2)
    out = tmp_path / "result.toml"
    cfg = _write_config(tmp_path, pct, pcs, output=str(out))
    rows = ",\n  ".join("[" + ", ".join(f"{v:.9g}" for v in r) + "]"
                        for r in R_true)
    out.write_text(f"[result]\nmse = 1e-9\ntranslation = "
                   f"[{', '.join(f'{v:.9g}' for v in t_true)}]\n"
                   f"rotation = [\n  {rows},\n]\n")
    png = tmp_path / "panel.png"
    assert visualize.main(["-c", str(cfg), "-r", str(out), "-o",
                           str(png)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    gif, png2 = tmp_path / "conv.gif", tmp_path / "run.png"
    assert visualize.main(["-c", str(cfg), "--run", "--device", "cpu",
                           "-o", str(png2), "--animate", str(gif)]) == 0
    assert gif.read_bytes()[:6] in (b"GIF87a", b"GIF89a")
    assert png2.stat().st_size > 1000


def test_kernel_check_tiny_grid_on_cpu(tmp_path):
    ok, lines, rows = kernel_check.run_check("tiny", "cpu")
    assert ok and len(lines) == len(rows)
    kernels = {r["kernel"] for r in rows}
    assert kernels == {"fused_bounds_lanes", "fused_bounds_lanes_trimmed",
                       "fused_bounds", "nn_min", "nn_argmin",
                       "argmin winner rescore", "minplus_1d",
                       "farthest_point_sample", "icp_align+icp_commit",
                       "pool_commit"}
    assert any(r["shape"].startswith("shard ") for r in rows)
    out = tmp_path / "kc.json"
    proc = _tool("kernel_check", "--grid", "tiny", "--device", "cpu",
                 "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    printed = json.loads(proc.stdout.strip().splitlines()[-1])
    assert printed == json.loads(out.read_text())
    assert printed["ok"] and printed["grid"] == "tiny"


def _recorded_search(recorder, label, runs=1):
    from fgoicp_tpu_torch.models.goicp import GoICP
    pct, pcs, _, _ = _make_problem(seed=0, angle=2.2)
    with recorder.record(label):
        for _ in range(runs):
            GoICP(pct, pcs, mse_threshold=5e-4,
                  engine=_t_engine(icp_multi_start=False),
                  bound_backend="proxy", proxy_size=64, device="cpu").run()


def test_recorder_keeps_one_call_a_launch_shape():
    rec = kernel_check.Recorder()
    _recorded_search(rec, "search", runs=2)
    kept = {}
    for (label, name, shapes, kw), (fn, args, kwargs) in rec.calls.items():
        assert label == "search" and fn.__name__ == name
        assert shapes == tuple(kernel_check._shape_key(a) for a in args)
        kept[name] = kept.get(name, 0) + 1
    assert {"nn_argmin", "nn_min", "fused_bounds_lanes"} <= set(kept)
    for name, n in kept.items():
        # Two runs launch the same shapes: each is kept once.
        assert n == min(len(rec.shapes[("search", name)]),
                        kernel_check.MAX_SHAPES)


def test_recorder_forwards_the_counters_and_restores_the_wrappers():
    from fgoicp_tpu_torch.ops import cuda_bounds, cuda_minplus, cuda_nn
    from fgoicp_tpu_torch.utils import trace
    mods = {"nn_argmin": cuda_nn, "nn_min": cuda_nn,
            "fused_bounds_lanes": cuda_bounds,
            "fused_bounds_lanes_trimmed": cuda_bounds,
            "fused_bounds": cuda_bounds, "minplus_1d": cuda_minplus}
    real = {name: getattr(mod, name) for name, mod in mods.items()}
    launches = {name: fn.launches for name, fn in real.items()}
    shapes = dict(cuda_nn.nn_argmin.shapes)
    rec = kernel_check.Recorder()
    with rec.record("counters"):
        assert all(getattr(mod, name) is not real[name]
                   for name, mod in mods.items())
        before = trace.launch_counts()
        # What each wrapper does after a launch on the card, through the
        # module attribute the recorder swapped.
        for name, mod in mods.items():
            getattr(mod, name).launches += 1
        cuda_nn.nn_argmin.shapes[(7, 9)] += 1
        after = trace.launch_counts()
    assert all(after[name] - before[name] == 1 for name in mods)
    assert all(getattr(mod, name) is real[name] for name, mod in mods.items())
    assert all(real[name].launches == launches[name] + 1 for name in mods)
    assert real["nn_argmin"].shapes[(7, 9)] == shapes.get((7, 9), 0) + 1
    for name in mods:
        real[name].launches -= 1
    real["nn_argmin"].shapes[(7, 9)] -= 1


def test_recorder_check_holds_every_shape_on_cpu():
    rec = kernel_check.Recorder()
    _recorded_search(rec, "search")
    n_calls = len(rec.calls)
    rows = rec.check()
    assert len(rows) == n_calls > 0 and not rec.calls
    assert all(r["ok"] and r["label"] == "search" and r["of"] >= 1
               and r["ms"] is None for r in rows)
    assert {"nn_argmin", "nn_min", "fused_bounds_lanes"} <= {
        r["kernel"] for r in rows}
    assert len({(r["kernel"], r["shape"]) for r in rows}) == len(rows)


def test_profile_phases_tiny(tmp_path):
    proc = _tool("profile_phases", *SMALL, "--runs", "1", "--no-multi-start")
    assert proc.returncode == 0, proc.stderr
    (line,) = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
    assert line["certified"] and line["nodes"] > 0
    assert set(line["phases_s"]) == {"initial_icp", "inner_bnb",
                                     "refine_icp", "spawn", "final_icp"}
    assert line["ms_per_icp_iteration"] > 0 and line["ms_per_inner_step"] > 0
    assert line["procrustes_steps"]["initial_icp"] > 0
    bad = _tool("profile_phases", "--workload", "bunny", "--device", "cpu")
    assert bad.returncode != 0 and "--data" in bad.stderr


def test_profile_phases_engine_flags_reach_the_engine():
    """The JAX tool's seven engine flags, with its defaults, go into
    EngineConfig; a tiny run at --icp-max-iter 3 --pool-lanes 64 reports
    them and stops every ICP call within 3 Procrustes steps."""
    from fgoicp_tpu_torch.scripts import profile_phases
    args = profile_phases.build_parser().parse_args([])
    eng = profile_phases.engine_of(args)
    assert (eng.source_coreset, eng.pool_lanes, eng.rotation_batch,
            eng.icp_max_iter, eng.icp_width, eng.pool_capacity,
            eng.icp_search_subsample) == (0, 1024, 16, 100, 16, 32768, 2048)
    flags = ["--source-coreset", "64", "--pool-lanes", "64",
             "--rotation-batch", "2", "--icp-max-iter", "3", "--icp-width",
             "4", "--pool-capacity", "4096", "--icp-search-subsample", "32"]
    eng = profile_phases.engine_of(profile_phases.build_parser().parse_args(
        flags))
    assert (eng.source_coreset, eng.pool_lanes, eng.rotation_batch,
            eng.icp_max_iter, eng.icp_width, eng.pool_capacity,
            eng.icp_search_subsample) == (64, 64, 2, 3, 4, 4096, 32)
    proc = _tool("profile_phases", *SMALL, "--runs", "1", "--no-multi-start",
                 "--icp-max-iter", "3", "--pool-lanes", "64")
    assert proc.returncode == 0, proc.stderr
    (line,) = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
    assert line["engine"]["icp_max_iter"] == 3
    assert line["engine"]["pool_lanes"] == 64
    assert line["engine"]["source_coreset"] == 0
    for phase in ("initial_icp", "final_icp"):
        assert 0 < line["procrustes_steps"][phase] <= 3 * line["calls"][phase]


def test_proxy_sweep_tiny():
    proc = _tool("proxy_sweep", *SMALL, "--runs", "1", "--sizes", "64", "32")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [ln["proxy"] for ln in lines] == [64, 32]
    assert all(ln["certified"] and ln["nodes"] > 0 for ln in lines)


def test_scaling_bench_one_and_two_gloo_ranks():
    proc = _tool("scaling_bench", "--device", "cpu", "--max-devices", "2",
                 "--groups", "8", "--ns", "96", "--nt", "256", "--lanes",
                 "32", "--proxy", "64", "--max-steps", "20")
    assert proc.returncode == 0, proc.stderr
    assert "WARNING" in proc.stderr and "not scaling" in proc.stderr
    rows = json.loads(proc.stdout.strip().splitlines()[-1])["scaling"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["nodes"] > 0 and r["nodes_per_s"] > 0 for r in rows)


def test_tools_import_no_jax():
    code = ("import sys\n"
            "import fgoicp_tpu_torch.scripts.kernel_check, "
            "fgoicp_tpu_torch.scripts.profile_phases, "
            "fgoicp_tpu_torch.scripts.proxy_sweep, "
            "fgoicp_tpu_torch.scripts.scaling_bench, "
            "fgoicp_tpu_torch.scripts.make_test_pair, "
            "fgoicp_tpu_torch.scripts.visualize, "
            "fgoicp_tpu_torch.native.loader, "
            "fgoicp_tpu_torch.parallel.distributed\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'fgoicp_tpu' not in sys.modules\n"
            "assert 'matplotlib' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
