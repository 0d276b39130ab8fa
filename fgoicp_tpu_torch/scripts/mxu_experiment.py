"""A/B: the direct-difference nearest-distance kernel against the norm
expansion on the tensor cores: the counterpart of the JAX package's
scripts/mxu_experiment.py (there the matrix units are a TPU's MXU).

The bound and NN kernels' inner op is a per-(query, point) squared
distance, min-reduced over the points.  Two mappings onto the card:

* `vpu` (shipped): d2 = (cx-qx)^2 + (cy-qy)^2 + (cz-qz)^2 in f32, exact:
  the port's kernel `cuda_nn.nn_min` on the card, `nn_min_plain` on the
  CPU.
* norm expansion: d2 = |q|^2 + |c|^2 - 2 q.c with the cross term as a
  matmul.  The contraction is K = 3 (xyz), padded to the tensor core's K,
  so the cores are at most 3/8 (TF32) busy, and the op cannot be deepened
  (packing points into K would sum the cross terms of different points).
  `mxu_bf16` rounds both operands to bfloat16 once (one pass; about 2^-8
  relative error in the cross term: unsound for a certificate);
  `mxu_hilo` splits each into hi + lo bfloat16 parts and sums the passes
  qh.ch + (qh.cl + ql.ch) (about 2^-16).

The cross term must stay f32: a bfloat16 torch.matmul returns bfloat16,
which would throw the hi/lo form's accuracy away.  So each pass multiplies
f32 tensors that hold bfloat16 values with TF32 allowed (bfloat16 values
and their products are exact in TF32 and f32; the sum accumulates in f32),
the TF32 flag set only inside `_min_d2` and restored after it (GoICP
refuses TF32 geometry).  On the CPU the flag does nothing and the product
is an f32 matmul of the same values.

    python -m fgoicp_tpu_torch.scripts.mxu_experiment [--big-only]
        [--device cuda]

P 4,096 points against Q 1,000,000 and 4,000,000 queries (--big-only: Q
4,000,000 only).  Prints one line a (Q, mode): wall ms
(CUDA events around each call, the best of 3 after a warm-up), Mq/s,
Top/s counting 9 operations a pair as the JAX script does (the tensor
cores do K-padded work beyond that), and max |d2 - vpu|; then one JSON
line of the table.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np

MODES = ("vpu", "mxu_hilo", "mxu_bf16")
P = 4096


def split_hilo(x):
    """(hi, lo): x rounded to bfloat16, and the rest rounded to bfloat16,
    both held in f32 (the JAX script's ch / cl)."""
    import torch
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def tf32_matmul():
    """TF32 matmuls on the card inside the block, the flag restored after."""
    import torch
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def cross_term(q, c, mode: str):
    """q . c^T [C, P] in f32 from bfloat16 passes: one (`mxu_bf16`) or the
    three of the hi/lo split (`mxu_hilo`)."""
    if mode == "mxu_bf16":
        return split_hilo(q)[0] @ split_hilo(c)[0].T
    if mode != "mxu_hilo":
        raise ValueError(mode)
    qh, ql = split_hilo(q)
    ch, cl = split_hilo(c)
    return qh @ ch.T + (qh @ cl.T + ql @ ch.T)


def _min_d2(queries, prox, mode: str = "vpu", q_chunk: int = 2048):
    """Min squared distance per query [Q] against `prox` [P, 3] (tensors
    on one device), by `mode` (MODES); the norm expansion in chunks of
    q_chunk queries."""
    import torch
    from ..ops import cuda_nn
    if mode == "vpu":
        return cuda_nn.nn_min(queries, prox)
    c2 = torch.sum(prox * prox, dim=-1)
    out = torch.empty(queries.shape[0], dtype=torch.float32,
                      device=queries.device)
    with tf32_matmul():
        for s in range(0, queries.shape[0], q_chunk):
            q = queries[s:s + q_chunk]
            q2 = torch.sum(q * q, dim=-1)
            d2 = q2[:, None] + c2[None, :] - 2.0 * cross_term(q, prox, mode)
            out[s:s + q_chunk] = torch.amin(d2, dim=-1)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--big-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def run(argv=None) -> list:
    args = build_parser().parse_args(argv)
    import torch
    from . import timing
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    prox = torch.as_tensor(rng.uniform(-1, 1, size=(P, 3)).astype(
        np.float32), device=dev)
    sizes = (4_000_000,) if args.big_only else (1_000_000, 4_000_000)
    print(f"device={dev} P={P}; Top/s counts 9 ops a pair (the tensor "
          f"cores pad K = 3 to their K)", flush=True)
    print(f"{'Q':>9} {'mode':>9} {'wall_ms':>9} {'Mq/s':>8} "
          f"{'Top/s(9op)':>10} {'max|d2 err|':>12}", flush=True)
    rows = []
    for nq in sizes:
        q = torch.as_tensor(rng.uniform(-1.2, 1.2, size=(nq, 3)).astype(
            np.float32), device=dev)
        exact = None
        for mode in MODES:
            out = _min_d2(q, prox, mode)
            wall = timing.best_ms(lambda: _min_d2(q, prox, mode), dev)
            if mode == "vpu":
                exact = out
                err = 0.0
            else:
                err = float(torch.max(torch.abs(out - exact)))
            rows.append(dict(q=nq, p=P, mode=mode, wall_ms=wall,
                             mq_per_s=nq / wall / 1e3,
                             tops_9op=nq * P * 9 / wall / 1e9,
                             max_abs_err=err))
            print(f"{nq:>9} {mode:>9} {wall:>9.3f} {nq / wall / 1e3:>8.1f} "
                  f"{nq * P * 9 / wall / 1e9:>10.2f} {err:>12.3e}",
                  flush=True)
    return rows


def main(argv=None) -> int:
    rows = run(argv)
    print(json.dumps({"tool": "mxu_experiment", "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
