"""One lockstep ICP iteration's non-NN work: the CUDA kernels
(`csrc/icp_step.cu`) and their plain torch versions.

No TPU kernel: the JAX package's ICP step (`fgoicp_tpu/models/icp.py`,
`fgoicp_tpu/ops/procrustes.py`) is XLA ops in a `lax.while_loop`.  An
iteration of `models/icp.py::icp_batched` is `icp_align` (correspondences,
Procrustes, the pose update, the points moved), the NN query, then
`icp_commit` (the SSE, the masked sse / last_sse updates, the loop guard,
the running lanes).  Both update the loop's state in place, and only for
the lanes not done; a done lane is left as it is.

Dispatch: tensors on the CPU go to the plain versions, which are the
loop's plain torch ops (`ops/procrustes.py`, masked selects) and give the
results bit for bit; CUDA tensors launch the kernels or raise — there is no
fallback from the card to the plain versions.  `icp_align.launches` and
`icp_commit.launches` count the kernel launches (the plain versions do not
count).

On the card each kernel runs one block a lane; the block's threads follow
from the lane's points alone (`block_threads`).
"""

from __future__ import annotations

import torch

from ..kernels import build
from ..utils import debug
from . import procrustes as proc_ops
from .cuda_nn import check_f32

# About POINTS_PER_THREAD points a thread, whole warps, at most MAX_THREADS
# threads a block (csrc/icp_step.cu's reduction buffers).
POINTS_PER_THREAD = 8
MAX_THREADS = 1024


def block_threads(ns: int) -> int:
    """Threads of a lane's block for ns points: ns / POINTS_PER_THREAD
    rounded up to whole warps, from 32 to MAX_THREADS."""
    warps = -(-ns // (32 * POINTS_PER_THREAD))
    return min(MAX_THREADS, max(32, 32 * warps))


def traffic(g: int, ns: int, weighted: bool = False):
    """The least work of one launch of each kernel over G lanes of ns
    points, as ((icp_align flops, bytes), (icp_commit flops, bytes)).
    Bytes a point: icp_align reads the point, its index and its gathered
    target point and writes the point (40 B), icp_commit reads d2 (4 B);
    weights add 4 B to each.  Flops a point: icp_align's three passes 13 +
    27 + 15, icp_commit 1."""
    w = 4 if weighted else 0
    return ((55.0 * g * ns, (40.0 + w) * g * ns),
            (1.0 * g * ns, (4.0 + w) * g * ns))


def masked(pred: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """Select new where pred (per lane), broadcasting over trailing dims."""
    shape = pred.shape + (1,) * (new.ndim - pred.ndim)
    return torch.where(pred.reshape(shape), new, old)


def icp_align_plain(target, idx, weights, done, cur, R, t, last_R, last_t,
                    running):
    """Plain torch version of `icp_align`, on any device: Procrustes on
    every lane, the running lanes' results kept by masked selects."""
    run = ~done
    corr = target[idx.long()]
    R_, t_ = proc_ops.procrustes(cur, corr, mask=weights)
    new_cur = torch.einsum("grc,gnc->gnr", R_, cur) + t_[:, None, :]
    new_R = torch.einsum("gab,gbc->gac", R_, R)
    new_t = torch.einsum("gab,gb->ga", R_, t) + t_
    last_R.copy_(masked(run, R, last_R))
    last_t.copy_(masked(run, t, last_t))
    R.copy_(masked(run, new_R, R))
    t.copy_(masked(run, new_t, t))
    cur.copy_(masked(run, new_cur, cur))


def icp_commit_plain(d2, weights, threshold, done, sse, last_sse, running):
    """Plain torch version of `icp_commit`, on any device."""
    run = ~done
    new_sse = torch.sum(d2 if weights is None else d2 * weights, dim=-1)
    last_sse.copy_(masked(run, sse, last_sse))
    sse.copy_(masked(run, new_sse, sse))
    # Reference loop guard: continue while
    # (last_sse - sse) > threshold * last_sse (icp3d.cu:94).
    conv = (last_sse - sse) <= threshold * last_sse
    done |= run & conv
    running.copy_(torch.sum(~done, dtype=torch.int32).reshape(1))


def _check_state(name, g, **tensors):
    """The shapes of the loop state: [G, ...] lanes, `done` [G] bool,
    `running` [1] int32; the float32 ones contiguous on one device."""
    shapes = dict(R=(g, 3, 3), t=(g, 3), last_R=(g, 3, 3), last_t=(g, 3),
                  sse=(g,), last_sse=(g,))
    floats = {}
    for key, a in tensors.items():
        if key in shapes and tuple(a.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} must be {shapes[key]}, "
                             f"got {tuple(a.shape)}")
        if key not in ("done", "running"):
            floats[key] = a
    device = check_f32(name, **floats)
    done, running = tensors["done"], tensors["running"]
    if done.dtype != torch.bool or tuple(done.shape) != (g,) \
            or done.device != device or not done.is_contiguous():
        raise ValueError(f"{name}: done must be a contiguous [{g}] bool "
                         f"tensor on {device}")
    if running.dtype != torch.int32 or running.numel() != 1 \
            or running.device != device:
        raise ValueError(f"{name}: running must be one int32 on {device}")
    return device


def _lanes(name, what, a, g, ns):
    if tuple(a.shape[:2]) != (g, ns) or a.numel() != g * ns:
        raise ValueError(f"{name}: {what} must be [{g}, {ns}], got "
                         f"{tuple(a.shape)}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def icp_align(target, idx, weights, done, cur, R, t, last_R, last_t,
              running):
    """One alignment step of every lane not done, in place: with c =
    target[idx] the correspondences of the points cur [G, ns, 3] (float32,
    contiguous) and `weights` [G, ns] (None: all 1), the lane's Procrustes
    motion (Q, t_) moves cur, last_R / last_t take R / t, and R, t become
    Q R, Q t + t_.  idx [G, ns] int32 contiguous; done [G] bool; running
    [1] int32 (zeroed on the card, for `icp_commit` to count)."""
    if cur.ndim != 3 or cur.shape[2] != 3 or cur.shape[1] == 0 \
            or cur.numel() >= 2 ** 31:
        raise ValueError(f"icp_align: cur must be [G, ns>0, 3] with 3 G ns "
                         f"< 2^31, got {tuple(cur.shape)}")
    g, ns = cur.shape[0], cur.shape[1]
    extra = {} if weights is None else dict(weights=weights)
    device = _check_state("icp_align", g, target=target, cur=cur, R=R, t=t,
                          last_R=last_R, last_t=last_t, done=done,
                          running=running, **extra)
    _lanes("icp_align", "idx", idx, g, ns)
    if weights is not None:
        _lanes("icp_align", "weights", weights, g, ns)
    if idx.dtype != torch.int32 or not idx.is_contiguous() \
            or idx.device != device:
        raise ValueError(f"icp_align: idx must be contiguous int32 on "
                         f"{device}")
    if target.ndim != 2 or target.shape[1] != 3 or target.shape[0] == 0:
        raise ValueError(f"icp_align: target must be [nt>0, 3], got "
                         f"{tuple(target.shape)}")
    if device.type == "cpu":
        icp_align_plain(target, idx, weights, done, cur, R, t, last_R,
                        last_t, running)
    else:
        lib = build.load()
        with torch.cuda.device(device):
            build.check(lib.fgoicp_icp_align(
                target.data_ptr(), idx.data_ptr(),
                None if weights is None else weights.data_ptr(),
                done.data_ptr(), g, ns, block_threads(ns), cur.data_ptr(),
                R.data_ptr(), t.data_ptr(), last_R.data_ptr(),
                last_t.data_ptr(), running.data_ptr(), _stream(device)),
                "icp_align")
        icp_align.launches += 1
    debug.check("icp_align", cur, R, t)


def icp_commit(d2, weights, threshold: float, done, sse, last_sse, running):
    """The SSE of every lane not done, sum_i w_i d2_i over d2 [G, n]
    (float32, contiguous; `weights` [G, n] or None), and the loop's step
    in place: last_sse takes sse, sse the new SSE, and done is set where
    last_sse - sse <= threshold * last_sse (icp3d.cu:94); running [1]
    int32 becomes the count of lanes not done."""
    if d2.ndim != 2 or d2.shape[1] == 0 or d2.numel() >= 2 ** 31:
        raise ValueError(f"icp_commit: d2 must be [G, n>0], got "
                         f"{tuple(d2.shape)}")
    g, n = d2.shape
    extra = {} if weights is None else dict(weights=weights)
    device = _check_state("icp_commit", g, d2=d2, sse=sse,
                          last_sse=last_sse, done=done, running=running,
                          **extra)
    if weights is not None:
        _lanes("icp_commit", "weights", weights, g, n)
    if device.type == "cpu":
        icp_commit_plain(d2, weights, threshold, done, sse, last_sse,
                         running)
    else:
        lib = build.load()
        with torch.cuda.device(device):
            build.check(lib.fgoicp_icp_commit(
                d2.data_ptr(), None if weights is None else weights.data_ptr(),
                g, n, block_threads(n), threshold, done.data_ptr(),
                sse.data_ptr(), last_sse.data_ptr(), running.data_ptr(),
                _stream(device)), "icp_commit")
        icp_commit.launches += 1
    debug.check("icp_commit", sse)


icp_align.launches = 0
icp_commit.launches = 0
