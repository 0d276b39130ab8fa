"""The port's experiment tools (fgoicp_tpu_torch/scripts: step_decomp,
micro_step, mxu_experiment, minplus_experiment) against the JAX package's
scripts and functions, at tiny sizes on the CPU, where every kernel wrapper
runs its plain version; the real-scan refusals and the imports of all six
tools.  hard_pairs and serving_experiment against the JAX package are in
test_torch_hard_pairs.py and test_torch_serving_experiment.py.

Tolerances, each stated where it is used:
* mxu_experiment's `vpu` within 2 ulps of the JAX script's (XLA on the
  CPU contracts the second and third product-and-sum into FMAs, so each of
  two roundings may fall differently); its hi/lo split bit-equal; the
  norm-expansion modes within 4 ulps of the JAX script's (f32 sums of the
  same exact bfloat16 products, in another order); the cross term equal to
  its float64 value within f32 rounding;
* step_decomp's pieces (sort and gathers, group minimum, incumbent minimum
  and first arg-minimum) equal to the same expressions in jnp;
* micro_step's pool drains at the step of JAX's bnb_r3_pooled on the same
  inputs, and its refusal reads as the JAX script's.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.ops import bounds as jbounds
from fgoicp_tpu.ops import geometry as jgeo
from fgoicp_tpu.ops import pool_frontier as jpool
from fgoicp_tpu_torch.scripts import (hard_pairs, micro_step,
                                      minplus_experiment, mxu_experiment,
                                      serving_experiment, step_decomp)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("step_decomp", "micro_step", "mxu_experiment", "minplus_experiment",
         "hard_pairs", "serving_experiment")


def _jax_script(name):
    """The JAX package's scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# mxu_experiment
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mxu_inputs():
    """Q 5,000 queries in +-1.2 and P 256 points in +-1, as the script draws
    them (at its sizes)."""
    rng = np.random.default_rng(0)
    prox = rng.uniform(-1, 1, size=(256, 3)).astype(np.float32)
    q = rng.uniform(-1.2, 1.2, size=(5000, 3)).astype(np.float32)
    return q, prox


def _ulps(a):
    return np.spacing(np.abs(np.asarray(a, np.float32)))


def test_mxu_vpu_matches_jax_within_two_ulps(mxu_inputs):
    q, prox = mxu_inputs
    want = np.asarray(_jax_script("mxu_experiment")._min_d2(q, prox, "vpu"))
    got = mxu_experiment._min_d2(torch.from_numpy(q), torch.from_numpy(prox),
                                 "vpu").numpy()
    assert np.all(np.abs(got - want) <= 2 * _ulps(want))


def test_mxu_hilo_split_is_bit_equal_to_jax(mxu_inputs):
    _, prox = mxu_inputs
    ch = jnp.asarray(prox).astype(jnp.bfloat16)
    cl = (jnp.asarray(prox) - ch.astype(jnp.float32)).astype(jnp.bfloat16)
    hi, lo = mxu_experiment.split_hilo(torch.from_numpy(prox))
    np.testing.assert_array_equal(hi.numpy(),
                                  np.asarray(ch.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.numpy(),
                                  np.asarray(cl.astype(jnp.float32)))


@pytest.mark.parametrize("mode", ["mxu_hilo", "mxu_bf16"])
def test_mxu_norm_expansion_matches_jax(mxu_inputs, mode):
    """Within 4 ulps of |q|^2 + |c|^2 (<= 7.32): the same exact products
    summed in f32 in another order; and each mode's error against vpu
    within its own scale (2^-14 and 2^-6 of 7.32)."""
    q, prox = mxu_inputs
    want = np.asarray(_jax_script("mxu_experiment")._min_d2(q, prox, mode))
    got = mxu_experiment._min_d2(torch.from_numpy(q), torch.from_numpy(prox),
                                 mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * _ulps(7.32))
    exact = mxu_experiment._min_d2(torch.from_numpy(q),
                                   torch.from_numpy(prox), "vpu").numpy()
    scale = 2.0 ** (-14 if mode == "mxu_hilo" else -6) * 7.32
    assert np.abs(got - exact).max() <= scale


def test_mxu_cross_term_stays_f32(mxu_inputs):
    """The trap: a bfloat16 torch.matmul returns bfloat16.  The hi/lo cross
    term must equal its float64 value from the same split within f32
    rounding (a few ulps of the largest partial sum), which a bfloat16
    result (8 bits) would miss by orders of magnitude."""
    q, prox = mxu_inputs
    qt, ct = torch.from_numpy(q[:512]), torch.from_numpy(prox)
    got = mxu_experiment.cross_term(qt, ct, "mxu_hilo").numpy()
    (qh, ql), (ch, cl) = (mxu_experiment.split_hilo(qt),
                          mxu_experiment.split_hilo(ct))
    d = lambda a, b: a.numpy().astype(np.float64) @ b.numpy().astype(
        np.float64).T
    exact = d(qh, ch) + (d(qh, cl) + d(ql, ch))
    assert got.dtype == np.float32
    assert np.all(np.abs(got - exact) <= 4 * _ulps(np.abs(exact) + 3.6))
    # and the true q . c within the hi/lo split's 2^-16 relative
    true = q[:512].astype(np.float64) @ prox.astype(np.float64).T
    assert np.abs(got - true).max() <= 2.0 ** -14
    bf16 = (qt.to(torch.bfloat16) @ ct.to(torch.bfloat16).T)
    assert bf16.dtype == torch.bfloat16
    assert np.abs(bf16.float().numpy() - true).max() > 2.0 ** -10


# ---------------------------------------------------------------------------
# step_decomp
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool():
    """step_decomp's pool arrays at a tiny size, the keys rounded to 1/64 so
    that many tie (the stable sort and the first arg-minimum then show);
    groups 40 and 41 hold no node."""
    keys, gid, cen, spn = step_decomp.pool_arrays(
        np.random.default_rng(0), 600, 40, "cpu")
    return torch.round(keys * 64) / 64, gid, cen, spn


def test_step_decomp_sort_matches_jax(pool):
    got = step_decomp.sort_gather(*pool)
    jk, jg, jc, js = (jnp.asarray(a.numpy()) for a in pool)
    order = jnp.argsort(jk)
    for g_, w_ in zip(got, (jk[order], jg[order], jc[order], js[order])):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def test_step_decomp_group_min_matches_jax(pool):
    keys, gid = pool[0], pool[1]
    got = step_decomp.group_min(keys, gid, 42).numpy()
    onehot = jnp.asarray(gid.numpy())[:, None] == jnp.arange(42)[None, :]
    want = jnp.min(jnp.where(onehot, jnp.asarray(keys.numpy())[:, None],
                             1e30), axis=0)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.all(got[40:] == np.float32(1e30))


def test_step_decomp_incumbent_matches_jax(pool):
    keys, gid = pool[0][:96], pool[1][:96]
    m, a = step_decomp.incumbent(keys, gid, 42)
    onehot = jnp.asarray(gid.numpy())[:, None] == jnp.arange(42)[None, :]
    grid = jnp.where(onehot, jnp.asarray(keys.numpy())[:, None], 1e10)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jnp.min(grid, 0)))
    np.testing.assert_array_equal(a.numpy(), np.asarray(jnp.argmin(grid, 0)))


def _main(tool, argv):
    """tool.main(argv) in this process: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_step_decomp_runs_tiny():
    rc, out, _ = _main(step_decomp, [
        "--device", "cpu", "--lanes", "16", "--capacity", "256", "--groups",
        "8", "--ns", "64", "--proxy", "32", "--nt", "300", "--iters", "8"])
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line["pieces_ms"]) == {"sort", "group_min", "incumbent",
                                      "kernel"}
    assert line["step_ms"] > 0 and line["drain_step"] == 8
    # No device: no launches, host reads or device time to count.
    assert line["step_launches"] is None and line["step_device_ms"] is None


# ---------------------------------------------------------------------------
# micro_step
# ---------------------------------------------------------------------------

# A pool that drains within a few steps at this size (nt, ns, P, G, L, CP).
TINY = dict(nt=300, ns=64, proxy=32, groups=4, lanes=64, capacity=1024)
TINY_ARGS = ["--device", "cpu"] + [a for k, v in TINY.items()
                                   for a in (f"--{k}", str(v))]


def test_micro_step_drain_matches_jax():
    """The JAX script's inputs (seed 0: target, source, rotations) through
    JAX's bnb_r3_pooled and through the port's micro_step pool: the pool
    drains at the same step, and micro_step refuses at --steps equal to it
    with the JAX script's message, warns below twice it, and runs."""
    t = TINY
    rng = np.random.default_rng(0)
    pct = rng.uniform(-0.9, 0.9, (t["nt"], 3)).astype(np.float32)
    pcs = rng.uniform(-0.7, 0.7, (t["ns"], 3)).astype(np.float32)
    backend = jbounds.make_backend(jnp.asarray(pct), kind="proxy",
                                   proxy_size=t["proxy"])
    R = jgeo.quat_cube_to_matrix(jnp.asarray(
        rng.uniform(-0.5, 0.5, (t["groups"], 3)), jnp.float32))
    st = jpool.bnb_r3_pooled(
        backend, jnp.asarray(pcs), R, jnp.full((t["groups"],), 0.25),
        jnp.zeros((t["groups"],), bool), jnp.float32(1e12),
        jnp.float32(-1.0), min_span=0.0, lanes=t["lanes"],
        capacity=t["capacity"], max_steps=400)
    ran = int(st.steps)
    assert 2 < ran < 400
    problem = micro_step.lane_problem(
        np.random.default_rng(0), t["nt"], t["ns"], t["proxy"], t["groups"],
        t["lanes"], "cpu")
    assert micro_step.pooled(problem, 400, t["lanes"],
                             t["capacity"]).steps == ran
    with pytest.raises(SystemExit) as refused:
        micro_step.main([*TINY_ARGS, "--steps", str(ran)])
    assert str(refused.value) == (
        f"pool drains at step {ran} <= --steps {ran}: the finite "
        f"difference would measure nothing — pass --steps <= "
        f"{max(1, ran // 2)}")
    steps = ran - 1
    rc, out, err = _main(micro_step, [*TINY_ARGS, "--steps", str(steps)])
    assert rc == 0
    assert f"WARNING: pool drains at step {ran} < {2 * steps}" in err
    line = json.loads(out.strip().splitlines()[-1])
    # A finite difference of host-clock times: on a loaded CPU either
    # difference may come out negative, so only its presence is checked.
    assert line["drain_step"] == ran
    assert np.isfinite(line["kernel_ms_per_step"])
    assert line["scheduler_ms_per_step"] == pytest.approx(
        line["pooled_ms_per_step"] - line["kernel_ms_per_step"])


# ---------------------------------------------------------------------------
# minplus_experiment
# ---------------------------------------------------------------------------


def test_minplus_experiment_f64_gate():
    out = minplus_experiment.run([
        "--device", "cpu", "--small", "64", "100", "--big", "128", "64",
        "--resolution", "0.05"])
    assert out["f64_check"]["shape"] == [64, 100]
    assert out["f64_check"]["ok"] and out["f64_check"]["max_err"] < 1e-4
    assert out["aligned"]["bits_equal"]
    fb = out["field_build"]
    assert fb["target"] == "bunny_synth" and fb["fields_equal"]
    assert len(fb["dims"]) == 3 and min(fb["dims"]) > 10
    # The plain build's rebinding is undone.
    from fgoicp_tpu_torch.ops import cuda_minplus
    assert cuda_minplus.minplus_1d.__name__ == "minplus_1d"


# ---------------------------------------------------------------------------
# the real scans, the imports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tool, args", [
    (hard_pairs, ["--pair", "090"]), (hard_pairs, ["--pair", "chin"]),
    (serving_experiment, ["--data", "{missing}"]),
    (minplus_experiment, ["--data", "{missing}"])])
def test_real_scans_refuse_without_data(tmp_path, tool, args):
    missing = str(tmp_path / "none")
    with pytest.raises(SystemExit) as refused:
        tool.run([a.format(missing=missing) for a in args]
                 + ["--device", "cpu"])
    assert "--data" in str(refused.value)
    if "{missing}" in args:
        assert missing in str(refused.value)
    else:
        assert "no --data given" in str(refused.value)


def test_tools_import_no_jax():
    code = ("import sys\n"
            + "".join(f"import fgoicp_tpu_torch.scripts.{t}\n" for t in TOOLS)
            + "assert 'jax' not in sys.modules\n"
            "assert 'fgoicp_tpu' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
