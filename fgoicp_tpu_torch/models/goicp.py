"""Go-ICP: globally-optimal registration via nested BnB over SE(3).

Counterpart of `fgoicp_tpu/models/goicp.py` in host outer mode.  Pipeline
parity with FastGoICP (reference fgoicp/fgoicp.{hpp,cpp}):
  1. normalize both clouds (center, source-max scale)        fgoicp.hpp:13-25
  2. initial ICP seeds the incumbent (cascaded multi-start)  fgoicp.cpp:12-14
  3. outer best-first BnB over the SO(3) quaternion cube      fgoicp.cpp:32-100
     - octree children, min half-span, SO(3) overlap tests
     - children overlapping-but-outside SO(3) re-queued with stale parent
       bounds (reference quirk, fgoicp.cpp:61-66 — reproduced)
     - per in-SO(3) child: inner R^3 BnB for the rotation upper bound
       (fix_rot) and lower bound, ICP refinement when
       ub < incumbent * 1.8 (fgoicp.cpp:69-96)
  4. final ICP polish (eps 0.0005) + translation de-normalization
     fgoicp.cpp:22-29

The outer priority queue stays on the host; each outer step pops a batch
of rotation nodes and evaluates all their children's inner searches in one
inner-BnB call: the pooled frontier (ops/pool_frontier.py, the default),
whose lanes run the fused lane kernels on the card, or the grouped
scheduler (ops/frontier.py, `frontier_mode="grouped"`), which runs the
fused grid kernel.  Triggered ICPs run as width-compacted batched ICP
(models/icp.py) on the nearest-neighbour kernels.

Trimming (trim_fraction > 0): the objective keeps the trim_keep =
round(ns * (1 - trim_fraction)) smallest residuals, in the bounds (trimmed
lane kernel, or the member-level clustered trim when source clusters are
set explicitly) and in every ICP and incumbent SSE.

The LUT bound backend (`bound_backend="lut"`) builds a distance field over
the normalized target at `lut_resolution` (ops/distance_field.py; the exact
EDT runs the `minplus_1d` kernel on the card) and bounds nodes by field
lookups; its search ICPs iterate on a proxy coreset built on the side.

Within one outer batch, all children see the incumbent from the start of
the step (the reference lets child k see child k-1's ICP improvement); this
only weakens in-search pruning slightly.

The serving mode (models/serving.py) hands two things to the engine of a
pair its batch did not certify: `seed_pose_centered`, the batch's seeding
pose in the source-centred frame, from which the initial ICP starts instead
of the 15-start sweep; and `shared_proxy`, one proxy coreset of the centred
target shared by every fallback and rescaled here to the pair's frame.

The device outer loop (`EngineConfig.outer_mode="device"`,
ops/so3_frontier.py) keeps the SO(3) frontier on the model's device and runs
the nested search in one call, or in checkpoint_every-step chunks when a
checkpoint path is set; an open device gap is re-certified by the host loop.
Checkpoints (`save_checkpoint` / `load_checkpoint(s)`, utils/checkpoint.py)
hold the host heap or the device SO3State in the JAX package's format, and
`debug_checks` runs the search-state sanitizer (utils/sanitize.py) at every
host outer step and device-state retrieval.

A (cubes, points) device mesh (`mesh=`, or engine.mesh_cubes /
mesh_points, parallel/sharding.py) runs one process per mesh position, each
with its own GoICP on the full clouds: the children's inner BnB, the ICP
lanes and the device loop's child evaluation shard over cubes, the bound
source and the ICP target over points (parallel/bnb.py), and every host
decision reads only results gathered to every rank, so the ranks step in
lockstep.  With a mesh every ICP runs on the full clouds, as in the JAX
package; mesh position 0 alone writes checkpoints (each host's own, when
the hosts of parallel/distributed.py run on meshes).  A 1 x 1 mesh only
sets the device.

`engine.pool_update="merge"` keeps the pooled frontier sorted by invariant
and merges each step's children into it (ops/pool_frontier.py), in the host
and device loops and on a mesh; "sort" is the default.

Tracing (utils/trace.py): `register` and `GoICP.run` called on its own
open a request record, which a model's construction ("construct" span),
its outer search ("bnb", counting "outer_steps", "rotation_children",
"rotation_pruned" and "icp_triggered" as GoICPStats does), its inner-BnB
calls ("inner_bnb", counting their bound evaluations as "inner_nodes")
and its host reads join.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import itertools
import math
from typing import Optional

import numpy as np
import torch

from ..config import Config, EngineConfig
from ..io import load_cloud
from ..ops import bounds as bounds_ops
from ..ops import coreset as coreset_ops
from ..ops import cuda_bounds
from ..ops import distance_field as df_ops
from ..ops import frontier as frontier_ops
from ..ops import geometry as geo
from ..ops import pool_frontier
from ..ops import so3_frontier as so3_ops
from ..parallel import bnb as pbnb
from ..parallel import sharding as psh
from ..utils import checkpoint as ckpt
from ..utils import logging as log
from ..utils import sanitize
from ..utils import trace
from . import icp as icp_model

BIG = 1e10  # reference M_INF (common.hpp:18)
# GoICPStats field -> the request count (utils/trace.py) of its growth.
_TRACED_STATS = {"outer_steps": "outer_steps",
                 "rotation_children": "rotation_children",
                 "rotation_pruned": "rotation_pruned",
                 "icp_triggered": "icp_triggered",
                 "translation_nodes": "inner_nodes"}
NO_CLOSED_LEAF = 1e29  # _closed_leaf_lb sentinel: no terminal leaf closed
_LUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}


@dataclasses.dataclass
class GoICPStats:
    rotation_nodes: int = 0        # outer nodes expanded
    rotation_children: int = 0     # in-SO(3) children evaluated
    rotation_pruned: int = 0       # children discarded by lb >= best_sse
    translation_nodes: int = 0     # inner bound evaluations (ref: count)
    icp_runs: int = 0
    icp_triggered: int = 0         # children passing the 1.8x trigger
    outer_steps: int = 0
    inner_loop_steps: int = 0
    dropped_nodes: int = 0
    wall_seconds: float = 0.0

    @property
    def cubes_per_second(self):
        return self.translation_nodes / max(self.wall_seconds, 1e-9)


def _check_fp32_matmul():
    """The geometric einsums must run in full fp32 (the JAX package pins
    precision=HIGHEST); refuse to run under TF32 rather than override the
    caller's global settings."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    if tf32 or precision != "highest":
        raise RuntimeError(
            "Go-ICP needs full-fp32 geometry: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest') (now "
            f"allow_tf32={tf32}, precision={precision!r})")


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device: {device!r}")
    return dev


def _check_engine(e: EngineConfig, bound_backend: str):
    """Unknown engine values raise ValueError, as in JAX."""
    if e.outer_mode not in ("host", "device"):
        raise ValueError(f"Unknown outer_mode: {e.outer_mode!r}")
    if e.frontier_mode not in ("pooled", "grouped"):
        raise ValueError(f"Unknown frontier_mode: {e.frontier_mode!r}")
    if e.pool_update not in ("sort", "merge"):
        raise ValueError(f"Unknown pool_update mode: {e.pool_update!r}")
    if bound_backend not in ("proxy", "exact", "lut"):
        raise ValueError(f"Unknown bound backend: {bound_backend}")


def _resolve_mesh(mesh, e: EngineConfig, device):
    """The caller's mesh, else engine.mesh_cubes x mesh_points ranks when
    that is more than one (parallel.sharding.make_mesh), else None."""
    if mesh is None and e.mesh_cubes * e.mesh_points > 1:
        mesh = psh.make_mesh(e.mesh_cubes, e.mesh_points, device=device)
    if mesh is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device!r} does not match the mesh's "
                         f"{mesh.device}")
    return mesh


class GoICP:
    """Globally-optimal registration engine.

    Public surface of icp::FastGoICP: construct with (target, source,
    lut_resolution, mse_threshold), call run(), read get_best_error /
    get_best_transform / get_last_transform (fgoicp.hpp:30-43).  Clouds are
    [N, 3] arrays (converted to float32 tensors on `device`).
    """

    @trace.spanned("construct")
    def __init__(self, pct, pcs, lut_resolution: float = 0.005,
                 mse_threshold: float = 1e-3,
                 engine: Optional[EngineConfig] = None,
                 bound_backend: str = "proxy", proxy_size: int = 1024,
                 trim_fraction: float = 0.0, mesh=None,
                 seed_pose_centered=None, shared_proxy=None,
                 device="cuda"):
        self.engine = engine or EngineConfig()
        e = self.engine
        pct = np.asarray(pct, np.float32)
        pcs = np.asarray(pcs, np.float32)
        for name, pc in (("target", pct), ("source", pcs)):
            if pc.ndim != 2 or pc.shape[1] != 3:
                raise ValueError(
                    f"{name} cloud must be [N, 3], got {pc.shape}")
            if pc.shape[0] < 3:
                raise ValueError(
                    f"{name} cloud needs at least 3 points, got {pc.shape[0]}")
            if not np.all(np.isfinite(pc)):
                raise ValueError(f"{name} cloud contains NaN/inf values")
        _check_engine(e, bound_backend)
        _check_fp32_matmul()
        self.mesh = _resolve_mesh(mesh, e, device)
        self.device = (self.mesh.device if self.mesh is not None
                       else _resolve_device(device))
        if self.mesh is not None and self.mesh.size == 1:
            self.mesh = None   # a 1 x 1 mesh is the single-device path
        trace.watch_mesh(self.mesh)
        dev = self.device
        self.ns, self.nt = len(pcs), len(pct)
        self.norm = geo.Normalization(torch.tensor(pct, device=dev),
                                      torch.tensor(pcs, device=dev))
        self.pct = self.norm.pct   # normalized target
        self.pcs = self.norm.pcs   # normalized source
        self.mse_threshold = mse_threshold
        self.sse_threshold = float(self.ns * mse_threshold)  # fgoicp.hpp:23
        self.trim_keep = (None if trim_fraction <= 0.0 else
                          max(1, int(round(self.ns * (1.0 - trim_fraction)))))
        if bound_backend == "lut":
            field = df_ops.build(
                self.pct, self.norm.target_bounds, lut_resolution,
                builder="ref" if e.ref_compat_lut else e.lut_builder,
                dtype=_LUT_DTYPES[e.lut_dtype], max_dim=e.lut_max_dim,
                warn_dim=e.lut_warn_dim)
            # conservative folds the field's error model into the distance
            # estimates (lb <= true SSE for EDT-built and narrow fields);
            # ref-compat mode drops the guarantee, as the reference's raw
            # texture lookup (registration.cu:320-328).
            self.backend = bounds_ops.make_backend(
                self.pct, kind="lut", field=field,
                conservative=e.lut_conservative, ref_compat=e.ref_compat_lut,
                lookup=e.lut_lookup)
        elif shared_proxy is not None and bound_backend == "proxy":
            # The caller's coreset of the CENTRED target, rescaled into this
            # pair's normalized frame: uniform scaling keeps the FPS choice,
            # and the covering radius scales linearly.
            f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                            device=dev)
            self.backend = bounds_ops.ProxyBackend(
                coreset=coreset_ops.ProxyCoreset(
                    points=f32(shared_proxy.points) * self.norm.scale,
                    eps=f32(shared_proxy.eps) * self.norm.scale))
        else:
            self.backend = bounds_ops.make_backend(
                self.pct, kind=bound_backend, proxy_size=proxy_size,
                seed=e.seed)
        # A seeding pose handed over by the serving batch, in the centred
        # (unscaled) source frame: only the translation scales.
        self._seed_pose = None
        if seed_pose_centered is not None:
            R_s, t_s = seed_pose_centered
            self._seed_pose = (np.asarray(R_s, np.float32),
                               np.asarray(t_s, np.float32)
                               * float(self.norm.scale))

        # Search-phase ICP target: the proxy coreset when it is smaller than
        # the full target (see _icp; the incumbent sse is always re-scored
        # exactly).  A LUT engine builds one on the side (none in ref-compat
        # mode): its bounds read the field, its search ICPs the coreset.
        self._icp_search_target = None
        if e.icp_search_on_proxy and proxy_size < self.nt:
            if isinstance(self.backend, bounds_ops.ProxyBackend):
                cs_pts = self.backend.coreset.points
                if cs_pts.shape[0] < self.nt:
                    self._icp_search_target = cs_pts
            elif not e.ref_compat_lut:
                self._icp_search_target = coreset_ops.build(
                    self.pct, size=proxy_size, seed=e.seed).points

        # Search-phase ICP source subsample (config.icp_search_subsample):
        # iteration-only, every incumbent is re-anchored by an exact
        # full-cloud NN pass in _icp.  Only when it cuts the per-iteration
        # work at least 2x.  A trimmed engine keeps the same kept share of
        # the subsample.
        self._icp_search_src = None
        self._icp_search_trim = self.trim_keep
        k_sub = e.icp_search_subsample
        if 0 < 2 * k_sub <= self.ns:
            sub = np.sort(np.random.default_rng(
                e.seed + 7).permutation(self.ns)[:k_sub])
            self._icp_search_src = self.pcs[torch.from_numpy(sub).to(dev)]
            if self.trim_keep is not None:
                self._icp_search_trim = max(1, int(round(
                    k_sub * self.trim_keep / self.ns)))

        # Hierarchical source clusters for search bounds (config docstring).
        # A trimmed engine builds them only when source_coreset is set
        # explicitly: trimmed cluster bounds carry the cluster radius on both
        # drop estimates, so the auto rule keeps trimmed engines on
        # full-source bounds (as the JAX package does).
        self.src_clusters = None
        src_k = e.source_coreset
        if src_k < 0:  # auto (config.py rule)
            src_k = (0 if self.ns <= 2048 else int(min(4096, max(
                1024, 2 ** round(math.log2(self.ns / 3))))))
        if src_k > 0 and self.ns > src_k and (
                self.trim_keep is None or e.source_coreset > 0):
            self.src_clusters = coreset_ops.build_weighted(
                self.pcs, size=src_k, seed=e.seed + 2)
            radius = trace.to_host(torch.max(self.src_clusters.deltas))
            log.debug(f"Source clusters: {src_k} reps, max radius "
                      f"{float(radius):.4f}")

        # The order in which the proxy bound kernels' warps take the source
        # points the frontier bounds (the clusters on the pooled path when
        # there are any, else the full source; trimmed engines have no auto
        # clusters): fixed for the engine, so built once here, not in every
        # kernel call.  The device loop always pools, whatever frontier_mode
        # says; the host loop it may fall back to follows frontier_mode.
        self._point_order = self._device_point_order = None
        if isinstance(self.backend, bounds_ops.ProxyBackend):
            pooled = (self.src_clusters.reps if self.src_clusters is not None
                      else self.pcs)
            host_src = pooled if e.frontier_mode == "pooled" else self.pcs
            self._point_order = self._source_order(host_src)
            if e.outer_mode == "device":
                self._device_point_order = (
                    self._point_order if host_src is pooled
                    else self._source_order(pooled))

        # Incumbent (runtime state, fgoicp.hpp:61-64).
        self.best_sse = BIG
        self.best_rotation = np.eye(3, dtype=np.float32)
        self.best_translation = np.zeros(3, np.float32)
        self.last_rotation = np.eye(3, dtype=np.float32)
        self.last_translation = np.zeros(3, np.float32)
        self.stats = GoICPStats()
        self._tie = itertools.count()
        self._heap = []
        # Checkpoints hash the clouds as given (float32, not normalized), as
        # the JAX package does, so a checkpoint resumes in either package.
        self._fingerprint = ckpt.cloud_fingerprint(pct, pcs)
        self._resumed_heap = None
        self._resumed_so3_state = None
        # Incumbent history: one entry per improvement,
        # (wall_seconds_since_run_start, sse, R, t_normalized).
        self.history = []
        self._t_start = None
        # The optimality gap the finished run certifies (incumbent minus
        # the lowest unexplored lower bound); <= sse_threshold means
        # certified optimal; None until a search ran.
        self.last_certified_gap = None
        # Min lb of terminal leaves the outer loop closed (children below
        # rotation_min_span discarded, fgoicp.cpp:53), folded into
        # last_certified_gap so frontier exhaustion cannot masquerade as a
        # certificate.
        self._closed_leaf_lb = NO_CLOSED_LEAF

        self.n_groups = e.rotation_batch * 8
        # Each lb-pass group [G:2G) shares its fixed-rotation twin's
        # incumbent (relaxed objective <= fixed objective pointwise).
        self._share = torch.cat([
            torch.full((self.n_groups,), -1, dtype=torch.int64),
            torch.arange(self.n_groups, dtype=torch.int64)]).to(dev)

    # ----- reference-parity getters (fgoicp.hpp:32-43) -----
    def get_best_error(self):
        return self.best_sse

    def get_best_transform(self):
        return self.best_rotation, self.best_translation

    def get_last_transform(self):
        return self.last_rotation, self.last_translation

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _source_order(self, points: torch.Tensor) -> torch.Tensor:
        """The proxy kernels' source order of points, or of this rank's
        shard of them on a mesh."""
        if self.mesh is None:
            return cuda_bounds.source_order(points)
        return pbnb.point_shard_order(points, self.mesh)

    # ------------------------------------------------------------------
    def _icp(self, R0, t0, active, convergence, search=False,
             max_iter=None):
        """Batched ICP; the returned sse is always EXACT on the full target
        (it feeds the pruning incumbent).

        search=True iterates against the proxy coreset when one exists and
        on the source subsample when one is configured; the final pose is
        then re-scored with one exact full-cloud NN pass, so the incumbent
        stays a true achievable SSE.  On a mesh the ICP runs on the full
        clouds (`parallel.bnb.icp_sharded`), as in the JAX package.
        Returns numpy (sse, R, t)."""
        mi = max_iter if max_iter is not None else self.engine.icp_max_iter
        if self.mesh is not None:
            sse, R, t = pbnb.icp_sharded(
                self.pct, self.pcs, self._tensor(R0), self._tensor(t0),
                self.mesh, active=torch.as_tensor(active, device=self.device),
                max_iter=mi, convergence_threshold=convergence,
                trim_keep=self.trim_keep)
            return trace.to_host(sse, R, t)
        target, src, trim = self.pct, self.pcs, self.trim_keep
        if search:
            if self._icp_search_target is not None:
                target = self._icp_search_target
            if self._icp_search_src is not None:
                src, trim = self._icp_search_src, self._icp_search_trim
        sse, R, t = icp_model.icp_batched(
            target, src, self._tensor(R0), self._tensor(t0),
            active=torch.as_tensor(active, device=self.device),
            max_iter=mi, convergence_threshold=convergence, trim_keep=trim)
        if target is not self.pct or src is not self.pcs:
            sse = icp_model.exact_sse_batched(self.pct, self.pcs, R, t,
                                              trim_keep=self.trim_keep)
        return trace.to_host(sse, R, t)

    def _icp_padded(self, R0, t0, n_active, convergence, search=False,
                    width=None, max_iter=None):
        """ICP in chunks of the fixed lane width (the tail padded with
        inactive identity lanes).  `width` overrides the engine lane width:
        the single-pose final polish runs width=1, because lanes compute in
        lockstep whether active or not."""
        w = width or self.engine.icp_width
        n = len(R0)
        outs = []
        for i in range(0, n, w):
            Rc = np.asarray(R0[i:i + w], np.float32)
            tc = np.asarray(t0[i:i + w], np.float32)
            k = len(Rc)
            if k < w:
                Rc = np.concatenate(
                    [Rc, np.tile(np.eye(3, dtype=np.float32),
                                 (w - k, 1, 1))])
                tc = np.concatenate([tc, np.zeros((w - k, 3), np.float32)])
            active = np.arange(w) < max(0, min(n_active - i, w))
            sse, R, t = self._icp(Rc, tc, active, convergence,
                                  search=search, max_iter=max_iter)
            outs.append((sse[:k], R[:k], t[:k]))
        return tuple(np.concatenate([o[j] for o in outs]) for j in range(3))

    def _initial_icp(self):
        """Seed the incumbent with cascaded multi-start ICP: stage 1 at the
        reference's eps=0.05 from identity plus the 14 multi-start
        rotations (from a handed-over seed pose plus identity instead, when
        given); a tighter warm-restart sweep and a full-cloud polish of the
        best lanes only when uncertified (config.icp_seed_fine_conv /
        icp_seed_polish)."""
        e = self.engine
        if self._seed_pose is not None:
            # The serving batch already swept the multi-start set: start
            # from its pose and from identity (the reference's own start).
            R0 = np.stack([self._seed_pose[0], np.eye(3, dtype=np.float32)])
            t0 = np.stack([self._seed_pose[1], np.zeros(3, np.float32)])
        else:
            R0 = (geo.multi_start_rotations() if e.icp_multi_start
                  else np.eye(3, dtype=np.float32)[None])
            t0 = np.zeros((len(R0), 3), np.float32)
        sse, R, t = self._icp_padded(
            R0, t0, len(R0), e.icp_convergence_init, search=True)
        k = int(np.argmin(sse[:len(R0)]))
        self.best_sse = float(sse[k])
        self.best_rotation, self.best_translation = R[k], t[k]
        self.stats.icp_runs += len(R0)
        if self.best_sse > self.sse_threshold and len(R0) > 1:
            # Cascade stage 2: warm-restart the sweep from the stage-1 poses
            # with a tighter cutoff so true basins rank first.  A seed-pose
            # run widens back to the 14 other starts: the pair is here
            # because the batch's winner did not certify.
            if self._seed_pose is not None and e.icp_multi_start:
                starts = geo.multi_start_rotations(include_identity=False)
                R = np.concatenate([R[:len(R0)], starts])
                t = np.concatenate([t[:len(R0)],
                                    np.zeros((len(starts), 3), np.float32)])
            sse, R, t = self._icp_padded(
                R, t, len(R), e.icp_seed_fine_conv, search=True)
            k = int(np.argmin(sse[:len(R)]))
            self.stats.icp_runs += len(R)
            if float(sse[k]) < self.best_sse:
                self.best_sse = float(sse[k])
                self.best_rotation, self.best_translation = R[k], t[k]
        if e.icp_seed_polish and self.best_sse > self.sse_threshold \
                and len(R0) > 1:
            # Cascade stage 3: re-descend the best fine-sweep basins on the
            # full clouds with a tighter cutoff.
            kk = np.argsort(sse[:len(R)])[:e.icp_seed_polish_width]
            sse2, R2, t2 = self._icp_padded(
                R[kk], t[kk], len(kk), e.icp_seed_polish_conv,
                search=False, width=e.icp_seed_polish_width,
                max_iter=e.icp_seed_polish_iters)
            k2 = int(np.argmin(sse2[:len(kk)]))
            self.stats.icp_runs += len(kk)
            if float(sse2[k2]) < self.best_sse:
                self.best_sse = float(sse2[k2])
                self.best_rotation = R2[k2]
                self.best_translation = t2[k2]
        self._record_improvement()
        log.info(f"Initial ICP best error: {self.best_sse}",
                 "\n\tRotation:\n", self.best_rotation,
                 "\n\tTranslation: ", self.best_translation)

    def _final_icp(self):
        """ICP polish, eps=0.0005 (fgoicp.cpp:22-23), one lane wide."""
        sse, R, t = self._icp_padded(
            np.asarray(self.best_rotation, np.float32)[None],
            np.asarray(self.best_translation, np.float32)[None],
            1, self.engine.icp_convergence_final, width=1)
        self.best_sse = float(sse[0])
        self.best_rotation, self.best_translation = R[0], t[0]
        self.stats.icp_runs += 1

    # ------------------------------------------------------------------
    def _spawn_children(self, popped):
        """Octree-split popped rotation nodes; classify by SO(3) tests.

        Returns the in-SO(3) children [(x, y, z, span)] to evaluate;
        overlapping children with centers outside SO(3) are pushed back
        with stale parent bounds (fgoicp.cpp:50-66).
        """
        eval_list = []
        unrefined = []
        for (lb, _, item) in popped:
            x, y, z, span, ub = item[:5]
            t_item = tuple(item[5:8])
            child_span = span / 2.0
            if child_span < self.engine.rotation_min_span:  # fgoicp.cpp:53
                # Closing a terminal leaf: its lb keeps bounding the
                # certificate gap.  Requeue-quirk leaves (center outside
                # SO(3)) were never evaluated: a claiming one gets its
                # refine ICP now, from the cube-center rotation, before the
                # subtree closes.
                if (x * x + y * y + z * z > 1.0
                        and lb < self.best_sse - self.sse_threshold):
                    unrefined.append((x, y, z) + t_item)
                self._closed_leaf_lb = min(self._closed_leaf_lb, float(lb))
                continue
            self.stats.rotation_nodes += 1
            for j in range(8):
                cx = x - child_span + ((j >> 0) & 1) * span
                cy = y - child_span + ((j >> 1) & 1) * span
                cz = z - child_span + ((j >> 2) & 1) * span
                r2 = cx * cx + cy * cy + cz * cz
                abs_sum = abs(cx) + abs(cy) + abs(cz)
                overlaps = (r2 - 2 * child_span * abs_sum
                            + 3 * child_span * child_span) <= 1.0
                if not overlaps:
                    continue
                if r2 > 1.0:
                    # Overlapping but center outside SO(3): requeue with
                    # the parent's bounds and inner translation (ref quirk).
                    heapq.heappush(self._heap, (lb, next(self._tie),
                                                (cx, cy, cz, child_span,
                                                 ub) + t_item))
                    continue
                eval_list.append((cx, cy, cz, child_span))
        if unrefined:
            arr = np.asarray(unrefined, np.float32)
            R0 = geo.quat_cube_to_matrix(torch.from_numpy(arr[:, :3])).numpy()
            t0 = arr[:, 3:6]
            sse, Ri, ti = self._icp_padded(
                R0, t0, len(R0), self.engine.icp_convergence_bnb,
                search=True)
            self.stats.icp_runs += len(R0)
            k = int(np.argmin(sse[:len(R0)]))
            if float(sse[k]) < self.best_sse:
                self.best_sse = float(sse[k])
                self.best_rotation, self.best_translation = Ri[k], ti[k]
                self._record_improvement()
        return eval_list

    @trace.spanned("inner_bnb")
    def _evaluate_children(self, children):
        """One inner-BnB call (pooled, or grouped by frontier_mode): ub-pass
        (fixed rotation, groups [0:G)) and lb-pass (groups [G:2G)) for all
        children."""
        e = self.engine
        g = self.n_groups
        n = len(children)
        arr = np.zeros((g, 4), np.float32)
        arr[:n] = np.asarray(children, np.float32)
        arr_t = self._tensor(arr)
        R = geo.quat_cube_to_matrix(arr_t[:, :3])                 # [G, 3, 3]
        active = torch.arange(g, device=self.device) < n
        R2 = torch.cat([R, R])
        spans2 = torch.cat([arr_t[:, 3], arr_t[:, 3]])
        fix2 = torch.cat([torch.ones(g, dtype=torch.bool),
                          torch.zeros(g, dtype=torch.bool)]).to(self.device)
        act2 = torch.cat([active, active])

        best, thr = (float(np.float32(self.best_sse)),
                     float(np.float32(self.sse_threshold)))
        if e.frontier_mode == "pooled":
            if self.src_clusters is not None:
                search_pcs = self.src_clusters.reps
                pw, pd = self.src_clusters.weights, self.src_clusters.deltas
            else:
                search_pcs, pw, pd = self.pcs, None, None
            pooled = (pool_frontier.bnb_r3_pooled if self.mesh is None else
                      functools.partial(pbnb.bnb_r3_pooled_sharded,
                                        mesh=self.mesh))
            st = pooled(
                self.backend, search_pcs, R2, spans2, fix2, best, thr,
                group_active=act2, min_span=e.translation_min_span,
                lanes=e.pool_lanes, capacity=e.pool_capacity,
                ref_compat_gamma=e.ref_compat_gamma,
                trim_keep=self.trim_keep, point_weights=pw, point_deltas=pd,
                err_share_from=self._share,
                trim_ns=(self.ns if self.trim_keep is not None else None),
                pool_update=e.pool_update, point_order=self._point_order)
        else:
            # The grouped scheduler bounds the full source, never clusters.
            grouped = (frontier_ops.bnb_r3_batched if self.mesh is None else
                       functools.partial(pbnb.bnb_r3_sharded,
                                         mesh=self.mesh))
            st = grouped(
                self.backend, self.pcs, R2, spans2, fix2, best, thr,
                group_active=act2, min_span=e.translation_min_span,
                batch=e.translation_batch, capacity=e.frontier_capacity,
                ref_compat_gamma=e.ref_compat_gamma,
                trim_keep=self.trim_keep, point_order=self._point_order)

        # Rotation lb = the lb-pass result: min(achieved, pruning incumbent)
        # keeps the threshold-slack guarantee when twin err-sharing ends a
        # search early; the dropped_lb clamp keeps it sound when pool
        # overflow discarded a node that could hold the min-lb witness.
        lb_raw = torch.minimum(st.best_ub[g:], st.best_err[g:])
        ub_g, bt_g, lb_raw_g, drop_g, R_np, evaluated, dropped = \
            trace.to_host(st.best_ub[:g], st.best_t[:g], lb_raw,
                          st.dropped_lb[g:], R, torch.sum(st.evaluated),
                          torch.sum(st.dropped))
        evaluated, dropped = int(evaluated), int(dropped)
        ub, best_t = ub_g[:n], bt_g[:n]
        lb_raw, drop_clamp = lb_raw_g[:n], drop_g[:n]
        lb = np.minimum(lb_raw, drop_clamp)
        if np.any(drop_clamp < lb_raw):
            log.warning(
                f"Inner-BnB pool overflow clamped "
                f"{int(np.sum(drop_clamp < lb_raw))} rotation lower "
                f"bound(s); the search stays exact but slower — increase "
                f"engine.pool_capacity")
        self.stats.translation_nodes += evaluated
        trace.count("inner_nodes", evaluated)
        self.stats.inner_loop_steps += st.steps
        self.stats.dropped_nodes += dropped
        return R_np, ub, best_t, lb

    def _refine_candidates(self, R, children, ub, best_t, lb=None):
        """Batched ICP on children passing the trigger (fgoicp.cpp:74-88),
        compacted into fixed-width chunks.

        The triggered set is topped up to a full icp_width batch with the
        lowest-ub non-triggered children (engine.icp_refine_best).  A child
        at the finest rotation level whose lb still claims an improvement
        (lb < best_sse - sse_threshold) gets an ICP lane regardless of its
        ub: the rotation tree is finite, so a subtree may only close once
        it is certified or refined."""
        n = len(children)
        trigger = ub[:n] < self.best_sse * self.engine.icp_trigger_factor
        if lb is not None and n > 0:
            spans = np.asarray([c[3] for c in children], np.float32)
            terminal = spans / 2.0 < self.engine.rotation_min_span
            claim = lb[:n] < self.best_sse - self.sse_threshold
            trigger = trigger | (terminal & claim)
        idxs = np.flatnonzero(trigger)
        self.stats.icp_triggered += int(idxs.size)
        trace.count("icp_triggered", int(idxs.size))
        w = self.engine.icp_width
        if self.engine.icp_refine_best and idxs.size < w and n > 0:
            in_trig = np.zeros(n, bool)
            in_trig[idxs] = True
            fill = [int(i) for i in np.argsort(ub[:n]) if not in_trig[i]]
            idxs = np.concatenate(
                [idxs, np.asarray(fill[:w - idxs.size], np.int64)])
        if idxs.size == 0:
            return
        self.stats.icp_runs += int(idxs.size)
        for i in range(0, idxs.size, w):
            chunk = idxs[i:i + w]
            R0 = np.asarray(R[:n][chunk], np.float32)
            t0 = np.asarray(best_t[chunk], np.float32)
            sse, Ri, ti = self._icp_padded(
                R0, t0, len(chunk), self.engine.icp_convergence_bnb,
                search=True)
            k = int(np.argmin(sse[:len(chunk)]))
            if sse[k] < self.best_sse:
                self.best_sse = float(sse[k])
                self.best_rotation, self.best_translation = Ri[k], ti[k]
                self._record_improvement()
                log.debug(f"New best error: {self.best_sse}",
                          "\n\tRotation:\n", self.best_rotation,
                          "\n\tTranslation: ", self._world_translation())

    def _record_improvement(self):
        elapsed = 0.0 if self._t_start is None else trace.now() - self._t_start
        self.history.append((elapsed, self.best_sse,
                             np.asarray(self.best_rotation),
                             np.asarray(self.best_translation)))

    # ----- checkpoint/resume (absent in the reference) -----
    def save_checkpoint(self, path: str):
        """Persist the outer heap + incumbent (atomic, fingerprinted).  It
        consumes one tie, as the JAX package does, so that a resumed heap
        orders its ties as an uninterrupted one.  On a mesh every rank
        consumes the tie (their heaps stay equal) and mesh position 0
        writes: with hosts on meshes, each host's own file."""
        tie = next(self._tie)
        if not self._writes_checkpoints():
            return
        ckpt.save(
            path, heap=list(self._heap), tie=tie,
            best_sse=self.best_sse, best_rotation=self.best_rotation,
            best_translation=self.best_translation,
            stats=dataclasses.asdict(self.stats),
            fingerprint=self._fingerprint,
            closed_leaf_lb=self._closed_leaf_lb)

    def _adopt_device_state(self, state, stats: dict):
        self._resumed_so3_state = state
        self.best_sse = float(state.best_sse)
        self.best_rotation = np.asarray(state.best_R, np.float32)
        self.best_translation = np.asarray(state.best_t, np.float32)
        self.stats = GoICPStats(**stats)

    def load_checkpoint(self, path: str):
        """Restore a checkpoint saved against the same cloud pair; the next
        run() skips the initial ICP and resumes the outer BnB.

        Host-heap checkpoints resume the host loop, device-state (SO3State)
        checkpoints the chunked device loop; a kind that does not match
        engine.outer_mode raises, naming the outer_mode to use."""
        if self.engine.outer_mode == "device":
            st = ckpt.load_device_state(path, fingerprint=self._fingerprint)
            state = so3_ops.state_from_arrays(st["state_arrays"])
            self._adopt_device_state(state, st["stats"])
            log.info(f"Resumed device checkpoint {path}: "
                     f"best_sse={self.best_sse}, "
                     f"outer_steps={int(state.outer_steps)}")
            return
        st = ckpt.load(path, fingerprint=self._fingerprint)
        self.best_sse = st["best_sse"]
        self.best_rotation = st["best_rotation"]
        self.best_translation = st["best_translation"]
        self.stats = GoICPStats(**st["stats"])
        self._tie = itertools.count(st["tie"])
        self._resumed_heap = st["heap"]
        self._closed_leaf_lb = min(self._closed_leaf_lb, st["closed_leaf_lb"])
        log.info(f"Resumed checkpoint {path}: best_sse={self.best_sse}, "
                 f"{len(self._resumed_heap)} frontier nodes")

    def load_checkpoints(self, paths):
        """Elastic recovery: merge several checkpoints, one per process of a
        partitioned run, into this model's resume state, then run().

        The partition keeps every unexplored SO(3) subtree in exactly one
        frontier, so the union of the frontiers plus the min incumbent
        covers the whole region not yet pruned (resuming one checkpoint
        alone would drop the others' subtrees and void the certificate).
        Every checkpoint must carry this pair's fingerprint and the kind of
        engine.outer_mode.  Counters sum; wall_seconds takes the max.
        """
        paths = list(paths)
        if not paths:
            raise ValueError("load_checkpoints needs at least one path")
        if len(paths) == 1:
            return self.load_checkpoint(paths[0])

        def merge_stats(acc, new):
            if acc is None:
                return dict(new)
            return {k: (max(acc[k], v) if k == "wall_seconds"
                        else acc[k] + v) for k, v in new.items()}

        stats = None
        if self.engine.outer_mode == "device":
            states = []
            for p in paths:
                st = ckpt.load_device_state(p, fingerprint=self._fingerprint)
                states.append(so3_ops.state_from_arrays(st["state_arrays"]))
                stats = merge_stats(stats, st["stats"])
            self._adopt_device_state(so3_ops.merge_states(states), stats)
            log.info(f"Merged {len(paths)} device checkpoints: "
                     f"best_sse={self.best_sse}")
            return
        heap, tie = [], 0
        best = (BIG, None, None)
        for p in paths:
            st = ckpt.load(p, fingerprint=self._fingerprint)
            self._closed_leaf_lb = min(self._closed_leaf_lb,
                                       st["closed_leaf_lb"])
            for lb, _t, node in st["heap"]:
                heap.append((lb, tie, node))
                tie += 1
            if st["best_sse"] < best[0]:
                best = (st["best_sse"], st["best_rotation"],
                        st["best_translation"])
            stats = merge_stats(stats, st["stats"])
        if best[1] is not None:
            self.best_sse, self.best_rotation, self.best_translation = best
        self.stats = GoICPStats(**stats)
        self._tie = itertools.count(tie)
        self._resumed_heap = heap
        log.info(f"Merged {len(paths)} host checkpoints: "
                 f"best_sse={self.best_sse}, {len(heap)} frontier nodes")

    def _maybe_checkpoint(self):
        e = self.engine
        if e.checkpoint_path and e.checkpoint_every > 0 and \
                self.stats.outer_steps % e.checkpoint_every == 0:
            self.save_checkpoint(e.checkpoint_path)

    # ----- outer loop hooks (names shared with the JAX package) -----
    def root_nodes(self):
        """Initial outer-frontier nodes: the full quaternion cube
        (fgoicp.cpp:36)."""
        return [(0.0, 0.0, 0.0, 1.0)]

    def seed_heap(self):
        """The outer heap: a resumed checkpoint's, else the root nodes."""
        if self._resumed_heap is not None:
            self._heap = list(self._resumed_heap)
            heapq.heapify(self._heap)
            self._resumed_heap = None
            return
        self._heap = []
        for (x, y, z, span) in self.root_nodes():
            heapq.heappush(
                self._heap,
                (0.0, next(self._tie),
                 (x, y, z, span, self.best_sse, 0.0, 0.0, 0.0)))

    def heap_min_lb(self) -> float:
        """Lowest unexplored lower bound (the local optimality gap floor)."""
        return self._heap[0][0] if self._heap else float(BIG)

    def outer_converged(self) -> bool:
        """Local termination test (fgoicp.cpp:44-47)."""
        return (not self._heap or
                self.best_sse - self._heap[0][0] <= self.sse_threshold)

    def outer_step(self) -> bool:
        """One outer BnB iteration: pop a batch, evaluate the children's
        inner searches, refine, push survivors.  Returns False when the
        frontier is exhausted."""
        e = self.engine
        if not self._heap:
            return False
        popped = []
        while self._heap and len(popped) < e.rotation_batch:
            popped.append(heapq.heappop(self._heap))
        children = self._spawn_children(popped)
        pruned = 0
        for i in range(0, len(children), self.n_groups):
            chunk = children[i:i + self.n_groups]
            R, ub, best_t, lb = self._evaluate_children(chunk)
            self.stats.rotation_children += len(chunk)
            self.last_rotation = R[len(chunk) - 1]
            self.last_translation = best_t[len(chunk) - 1]
            self._refine_candidates(R, chunk, ub, best_t, lb=lb)
            for k, (cx, cy, cz, cspan) in enumerate(chunk):
                if lb[k] >= self.best_sse:  # fgoicp.cpp:92
                    pruned += 1
                    continue
                heapq.heappush(
                    self._heap,
                    (float(lb[k]), next(self._tie),
                     (cx, cy, cz, cspan, float(ub[k]),
                      float(best_t[k][0]), float(best_t[k][1]),
                      float(best_t[k][2]))))
        self.stats.rotation_pruned += pruned
        self.stats.outer_steps += 1
        trace.count("rotation_children", len(children))
        trace.count("rotation_pruned", pruned)
        trace.count("outer_steps")
        self._maybe_checkpoint()
        if e.debug_checks:
            sanitize.check_heap(self._heap)
            sanitize.check_incumbent(self)
        return True

    @trace.spanned("bnb")
    def _branch_and_bound_so3(self):
        """Outer loop (fgoicp.cpp:32-100), batched over rotation nodes."""
        if self.engine.outer_mode == "device":
            return self._bnb_so3_device()
        return self._bnb_so3_host()

    def _bnb_so3_host(self):
        self.seed_heap()
        while self._heap and not self.outer_converged():
            self.outer_step()
        self.last_certified_gap = float(
            self.best_sse - min(self.heap_min_lb(), self._closed_leaf_lb))
        return self.best_sse

    # SO3State counter field -> GoICPStats field (device outer mode); the
    # request counts the growth of each under the GoICPStats name (but
    # "inner_nodes" for translation_nodes, as the host loop does).
    _DEVICE_COUNTERS = {
        "outer_steps": "outer_steps",
        "nodes_expanded": "rotation_nodes",
        "children_evaluated": "rotation_children",
        "inner_nodes": "translation_nodes",
        "icp_runs": "icp_runs",
        "icp_triggered": "icp_triggered",
        "pruned": "rotation_pruned",
    }
    _DEVICE_MAX_OUTER = 10000   # safety valve of the device loop (chunked
    #                             runs respect it too); the host loop has none

    def _flush_device_counters(self, st, last):
        """Add the counter delta since `last` into self.stats (SO3State
        counters are cumulative across chunks and resumes)."""
        for f, g in self._DEVICE_COUNTERS.items():
            cur = int(getattr(st, f))
            setattr(self.stats, g, getattr(self.stats, g) + cur - last[f])
            if g in _TRACED_STATS:
                trace.count(_TRACED_STATS[g], cur - last[f])
            last[f] = cur

    def _sanitize_device_state(self, st):
        """The sanitizer on a retrieved SO3State when engine.debug_checks is
        on (chunk boundaries and the final retrieval)."""
        if self.engine.debug_checks:
            sanitize.check_device_state(st)

    def _writes_checkpoints(self) -> bool:
        """Whether this rank writes the checkpoints: off a mesh always, on
        one its position 0 (`Mesh.rank`, not the world rank: a host's mesh
        in a world of hosts on meshes may hold no world rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _save_device_checkpoint(self, st):
        if not self._writes_checkpoints():
            return
        ckpt.save_device_state(
            self.engine.checkpoint_path,
            state_arrays={f: np.asarray(getattr(st, f)) for f in st._fields},
            stats=dataclasses.asdict(self.stats),
            fingerprint=self._fingerprint)

    def _device_call_fn(self):
        """``call(init_state, max_outer) -> SO3State`` (tensors on the
        model's device) bound to this model's engine and backend.  The
        incumbent is read from ``self`` at each call and ignored whenever
        ``init_state`` is given (the state carries its own)."""
        e = self.engine
        if self.src_clusters is not None:
            search_pcs = self.src_clusters.reps
            pw, pd = self.src_clusters.weights, self.src_clusters.deltas
        else:
            search_pcs, pw, pd = self.pcs, None, None
        kw = dict(
            rotation_batch=e.rotation_batch, capacity=e.so3_capacity,
            rotation_min_span=e.rotation_min_span,
            translation_min_span=e.translation_min_span,
            pool_lanes=e.pool_lanes, pool_capacity=e.pool_capacity,
            ref_compat_gamma=e.ref_compat_gamma,
            icp_width=e.icp_width, icp_max_iter=e.icp_max_iter,
            icp_convergence=e.icp_convergence_bnb,
            icp_trigger_factor=e.icp_trigger_factor,
            icp_refine_best=e.icp_refine_best,
            trim_ns=(self.ns if self.trim_keep is not None else None),
            pool_update=e.pool_update, point_order=self._device_point_order,
            device=self.device)

        device_loop = so3_ops.so3_bnb_device
        if self.mesh is not None:
            # Frontier replicated, child evaluation sliced over cubes,
            # clouds over points.
            device_loop = functools.partial(pbnb.so3_bnb_device_sharded,
                                            mesh=self.mesh)

        def call(init_state, max_outer):
            return device_loop(
                self.backend, self.pct, self.pcs, search_pcs,
                np.float32(self.best_sse),
                np.asarray(self.best_rotation, np.float32),
                np.asarray(self.best_translation, np.float32),
                self.sse_threshold, point_weights=pw, point_deltas=pd,
                icp_search_target=self._icp_search_target,
                icp_search_src=self._icp_search_src,
                icp_search_trim=self._icp_search_trim,
                trim_keep=self.trim_keep, init_state=init_state,
                max_outer=max_outer, **kw)

        return call

    def _device_adopt(self, st, hist_seen, last=None):
        """Fold a retrieved (numpy) SO3State into the model: ring entries
        past `hist_seen`, the incumbent, the counter deltas (when `last` is
        given); clear the host heap.  The ring keeps no wall-clock, so its
        entries carry the retrieval's elapsed time."""
        elapsed = (0.0 if self._t_start is None
                   else trace.now() - self._t_start)
        n_hist = int(st.hist_len)
        ring_cap = st.hist_sse.shape[0]
        if hist_seen >= ring_cap:
            # Resumed from a saturated ring: hist_len stays at capacity
            # while improvements after the resume overwrite the last slot,
            # so that slot counts as unseen.
            hist_seen = ring_cap - 1
        for j in range(hist_seen, n_hist):
            if (self.history
                    and float(st.hist_sse[j]) >= self.history[-1][1]):
                continue  # saturated last slot unchanged since the resume
            self.history.append(
                (elapsed, float(st.hist_sse[j]),
                 np.asarray(st.hist_R[j]), np.asarray(st.hist_t[j])))
        if n_hist == ring_cap:
            log.debug("device history ring saturated; intermediate "
                      "improvements were overwritten into the last slot")
        if float(st.best_sse) < self.best_sse:
            self.best_sse = float(st.best_sse)
            self.best_rotation = np.asarray(st.best_R)
            self.best_translation = np.asarray(st.best_t)
        self.last_rotation = np.asarray(st.best_R)
        self.last_translation = np.asarray(st.best_t)
        if last is not None:
            self._flush_device_counters(st, last)
        self._heap = []
        if self.engine.debug_checks:
            sanitize.check_device_state(st)
            sanitize.check_incumbent(self)

    def _bnb_so3_device(self):
        """The whole nested BnB with the frontier on the device
        (ops/so3_frontier.py): one call, or with checkpoint_path set, calls
        of checkpoint_every outer steps each resuming the previous chunk's
        SO3State, which is saved atomically between chunks.  Every state
        comes back to the host in one copy (`so3_frontier.to_host`)."""
        call = self._device_call_fn()
        e = self.engine
        st0 = self._resumed_so3_state
        self._resumed_so3_state = None
        last = {f: (0 if st0 is None else int(getattr(st0, f)))
                for f in self._DEVICE_COUNTERS}
        hist_seen = 0 if st0 is None else int(st0.hist_len)
        # The step valve is relative to the resume point: merged
        # checkpoints sum their counters (so3_frontier.merge_states), and an
        # absolute valve would skip the search they exist for.
        valve = ((0 if st0 is None else int(st0.outer_steps))
                 + self._DEVICE_MAX_OUTER)
        chunk = (e.checkpoint_every
                 if (e.checkpoint_path and e.checkpoint_every > 0) else 0)
        if chunk <= 0:
            st = so3_ops.to_host(call(st0, valve))
        else:
            st = st0
            while True:
                start = 0 if st is None else int(st.outer_steps)
                cap = min(start + chunk, valve)
                st = so3_ops.to_host(call(st, cap))
                self._sanitize_device_state(st)
                self._flush_device_counters(st, last)  # updates `last`
                self._save_device_checkpoint(st)
                if int(st.outer_steps) < cap or cap >= valve:
                    break   # gap closed / frontier empty / safety valve
            last = None  # counters already flushed chunk by chunk
        self._device_adopt(st, hist_seen, last)
        # A device search can end without a certificate: the fixed frontier
        # dropped a subtree, max_outer cut the loop, or a claim leaf closed.
        # Those subtrees are gone from the device state, so the host loop
        # re-certifies from the root with the device incumbent, which prunes
        # fast.  (The JAX package's host-side gap, in float64.)
        floor = min(float(st.lbs[0]), float(st.dropped_lb),
                    float(st.closed_lb))
        gap = -so3_ops.BIG if floor >= so3_ops.INVALID \
            else float(st.best_sse) - floor
        self.last_certified_gap = gap
        if gap > self.sse_threshold:
            log.warning(
                f"Device SO(3) search ended with an open certificate gap "
                f"({gap:.3g} > {self.sse_threshold:.3g}; frontier overflow, "
                f"max_outer, or a closed claim leaf) — re-certifying with "
                f"the host loop (raise engine.so3_capacity to avoid this)")
            self._bnb_so3_host()
        return self.best_sse

    def _world_translation(self) -> np.ndarray:
        return trace.to_host(self.norm.restore_translation(
            self._tensor(self.best_rotation),
            self._tensor(self.best_translation)))

    # ------------------------------------------------------------------
    @trace.entry("register")
    def run(self):
        """Full pipeline; returns (R, t) as numpy in the ORIGINAL (world)
        frame (fgoicp.cpp:10-30).  wall_seconds and the history's times are
        on the tracer's monotonic clock."""
        trace.watch_mesh(self.mesh)
        t0 = trace.now()
        self._t_start = t0
        if self._resumed_heap is None and self._resumed_so3_state is None:
            self._initial_icp()
        self._branch_and_bound_so3()
        self._final_icp()
        self._record_improvement()
        self.stats.wall_seconds = trace.now() - t0
        t_world = self._world_translation()
        log.info(f"Searching over! Best Error: {self.best_sse}",
                 "\n\tRotation:\n", self.best_rotation,
                 "\n\tTranslation: ", t_world)
        return self.best_rotation, t_world

    @property
    def mse(self):
        return self.best_sse / self.ns


@trace.entry("register")
def register(config: Config, pct=None, pcs=None, device="cuda"):
    """Config-driven entry (mirrors main.cpp:41-53); returns (model, R, t)."""
    if pct is None:
        pct = load_cloud(config.io.target, config.params.target_subsample,
                         seed=config.engine.seed)
        log.info(f"Target point cloud ({len(pct)}) loaded from {config.io.target}")
    if pcs is None:
        pcs = load_cloud(config.io.source, config.params.source_subsample,
                         seed=config.engine.seed + 1)
        log.info(f"Source point cloud ({len(pcs)}) loaded from {config.io.source}")
    model = GoICP(
        pct, pcs, lut_resolution=config.params.lut_resolution,
        mse_threshold=config.params.mse_threshold, engine=config.engine,
        trim_fraction=(config.params.trim_fraction if config.params.trim else 0.0),
        device=device)
    R, t = model.run()
    return model, R, t
