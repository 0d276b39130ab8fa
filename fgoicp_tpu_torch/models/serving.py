"""Batched multi-pair registration: the serving mode.

Counterpart of `fgoicp_tpu/models/serving.py`.  The reference registers one
cloud pair per process run (src/main.cpp:41-53).  Deployments that localize
many scans against one known model (a map, a CAD part, an atlas) build
`RegistrationService` once over the shared target and register a whole
batch of source clouds per call:

  1. **Batched seeding** (`_seed_pairs`): all B pairs x S multi-start
     rotations run as one lane-batched ICP (models/icp.py with per-lane
     sources) against a shared proxy coreset of the target, on a source
     subsample; the final poses are re-scored exactly on the full target
     and the B winners polished on the full clouds.  One call for the
     batch whatever B, and one copy of its results to the host.
  2. **Certified gap check**: a pair whose normalized SSE is at most
     ns * mse_threshold meets the reference's own termination rule at the
     root (best_sse - lb_root <= sse_threshold with lb_root = 0,
     fgoicp.cpp:44-47): the pose is certified, by the certificate a full
     BnB run would exit with at once.
  3. **BnB fallback**: pairs left open run the full nested BnB
     (models/goicp.py) one by one, handed the batch's seeding pose and ONE
     proxy coreset of the target shared by every fallback; if the seed does
     not certify, GoICP's cascade widens back to the full start set before
     the BnB does any work.

Frames: seeding runs on CENTRED clouds without the reference's source-max
rescaling (ICP is scale-free; only the BnB's translation domain needs the
unit cube).  The certificate converts instead: normalized SSE = scale^2 *
SSE_centred with scale = 1 / max|centred source|, so the check equals the
engine's normalized-frame rule.  Returned poses are in the world frame.

The service runs on one device (`device`, cuda by default); sharding the
pair batch over several GPUs is ROADMAP Queue 1 item 16 (multi-GPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import EngineConfig
from ..ops import coreset as coreset_ops
from ..ops import geometry as geo
from ..utils import logging as log
from . import icp as icp_model
from .goicp import GoICP, _check_fp32_matmul, _resolve_device


@dataclasses.dataclass
class PairResult:
    """Registration result for one source cloud (world frame)."""
    R: np.ndarray            # [3, 3]
    t: np.ndarray            # [3]
    sse: float               # normalized-frame SSE (engine units)
    mse: float               # sse / ns (comparable to GoICP.mse)
    certified: bool          # optimality gap <= ns * mse_threshold
    fallback_used: bool      # pair needed the full BnB


@dataclasses.dataclass
class ServiceStats:
    pairs: int = 0
    certified_by_seeding: int = 0
    fallbacks: int = 0
    seed_seconds: float = 0.0
    fallback_seconds: float = 0.0


def start_rotations(multi_start: bool = True) -> np.ndarray:
    """[S, 3, 3] ICP seed rotations: identity (+ the engine's 14-start set,
    geometry.multi_start_rotations, so the serving sweep and the engine's
    cascade use the same starts)."""
    if not multi_start:
        return np.eye(3, dtype=np.float32)[None]
    return geo.multi_start_rotations()


def _seed_pairs(pct_c: torch.Tensor, icp_target: torch.Tensor,
                sources: torch.Tensor, starts_R: torch.Tensor,
                convergence: float, convergence_final: float, seed_idx=None,
                trim_keep=None, max_iter: int = 100, rescore: bool = True,
                point_weights=None):
    """Multi-start ICP seeding for a whole pair batch, in one batched ICP.

    The engine's phases before a BnB that closes at once (fgoicp.cpp:10-30):
    seeding ICP (eps=convergence) over all B*S lanes against icp_target,
    exact full-target rescore to pick each pair's best start, then the
    final polish (eps=convergence_final) of the B winners against the full
    target, whose carried SSE is already exact.

    pct_c [nt, 3] centred target; icp_target the ICP iteration target
    (proxy coreset or pct_c); sources [B, ns, 3] raw source clouds; starts_R
    [S, 3, 3]; seed_idx None, [k] or per pair [B, k] int64 rows of the
    seeding subsample; point_weights [B, ns] (ragged batches: 0 on
    padding).  Tensors on one device.  Lanes are pair-major: lane b*S + s
    runs start s on pair b.
    Returns per pair (sse_centred [B], R [B, 3, 3], t [B, 3], scale [B],
    mu_s [B, 3]): sse in the centred (unscaled) frame; scale converts it to
    the engine's normalized frame (module docstring).
    """
    b, ns, _ = sources.shape
    s_cnt = starts_R.shape[0]
    w = point_weights
    if w is None:
        mu_s = torch.mean(sources, dim=1)                          # [B, 3]
        src_c = sources - mu_s[:, None, :]
        scale = 1.0 / torch.amax(torch.abs(src_c), dim=(1, 2))     # [B]
    else:
        # Ragged batch: padding rows repeat a real point with weight 0; the
        # mean, the extent and the certificate must ignore them.
        wn = w[..., None]
        mu_s = (torch.sum(sources * wn, dim=1)
                / torch.clamp(torch.sum(wn, dim=1), min=1e-12))
        src_c = sources - mu_s[:, None, :]
        scale = 1.0 / torch.amax(
            torch.where(wn > 0, torch.abs(src_c), 0.0), dim=(1, 2))

    # Seeding iterates on a SOURCE subsample too: the B*S-lane phase only
    # has to find each pair's basin; rescore, polish and certificate run on
    # the full clouds, so the subsample only changes which start wins.
    if seed_idx is None:
        src_seed, w_seed = src_c, w
    elif seed_idx.ndim == 1:
        src_seed = src_c[:, seed_idx]
        w_seed = None if w is None else w[:, seed_idx]
    else:
        # Per-pair rows: a ragged pair samples only its REAL rows.
        src_seed = torch.gather(
            src_c, 1, seed_idx[:, :, None].expand(-1, -1, 3))
        w_seed = None if w is None else torch.gather(w, 1, seed_idx)
    seed_trim = trim_keep
    if trim_keep is not None and seed_idx is not None:
        seed_trim = max(1, int(round(src_seed.shape[1] * trim_keep / ns)))
    R0 = starts_R.repeat(b, 1, 1)                                  # tiled
    t0 = torch.zeros((b * s_cnt, 3), dtype=torch.float32,
                     device=sources.device)
    lanes = lambda a: None if a is None else a.repeat_interleave(s_cnt, 0)
    sse_icp, R_l, t_l = icp_model.icp_batched(
        icp_target, lanes(src_seed), R0, t0, max_iter=max_iter,
        convergence_threshold=convergence, trim_keep=seed_trim,
        point_weights=lanes(w_seed))
    if rescore or seed_idx is not None or w is not None:
        # The exact full-cloud SSE ranks the starts (proxy- or subsample-
        # iterated SSEs are biased).
        sse_l = icp_model.exact_sse_batched(
            pct_c, lanes(src_c), R_l, t_l, trim_keep=trim_keep,
            point_weights=lanes(w))
    else:
        sse_l = sse_icp  # iterated on the full clouds: already exact
    sse_b = sse_l.reshape(b, s_cnt)
    k = torch.argmin(sse_b, dim=1)                                 # [B]
    pairs = torch.arange(b, device=sources.device)
    lane = pairs * s_cnt + k
    # Final polish (fgoicp.cpp:22-23) of each pair's winning pose.
    sse_p, R_p, t_p = icp_model.icp_batched(
        pct_c, src_c, R_l[lane], t_l[lane], max_iter=max_iter,
        convergence_threshold=convergence_final, trim_keep=trim_keep,
        point_weights=w)
    # The polish keeps the better of its last two iterates on its own
    # target, which is pct_c: it cannot worsen the exact objective, but the
    # select is kept as a guard.
    seeded = sse_b[pairs, k]
    better = sse_p < seeded
    return (torch.where(better, sse_p, seeded),
            torch.where(better[:, None, None], R_p, R_l[lane]),
            torch.where(better[:, None], t_p, t_l[lane]), scale, mu_s)


class RegistrationService:
    """Batched registration of many source clouds against one target.

    Usage::

        srv = RegistrationService(model_cloud, mse_threshold=1e-3)
        results = srv.register(np.stack(scans))   # [B, ns, 3]
        for r in results:
            r.R, r.t, r.certified, ...

    The target-side structures (centred cloud, proxy coreset) are built
    once on `device` (cuda by default; the CPU only when asked); `register`
    takes any number of batches.
    """

    def __init__(self, target, mse_threshold: float = 1e-3,
                 engine: Optional[EngineConfig] = None,
                 proxy_size: int = 4096, trim_fraction: float = 0.0,
                 seed_subsample: int = 2048, mesh=None,
                 fallback_proxy_size: Optional[int] = None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "sharding the pair batch over a mesh is ROADMAP Queue 1 "
                "item 16 (multi-GPU)")
        self.engine = engine or EngineConfig()
        target = np.asarray(target, np.float32)
        if target.ndim != 2 or target.shape[1] != 3:
            raise ValueError(f"target cloud must be [N, 3], got {target.shape}")
        if not np.all(np.isfinite(target)):
            raise ValueError("target cloud contains NaN/inf values")
        _check_fp32_matmul()
        self.device = _resolve_device(device)
        self.pct = target
        self.nt = len(target)
        self.mse_threshold = float(mse_threshold)
        self.trim_fraction = float(trim_fraction)
        # proxy_size sizes the SEEDING ICP's iteration target; the BnB
        # fallback's bound proxy has its own knob (default 1024, GoICP's).
        self.proxy_size = int(proxy_size)
        self.fallback_proxy_size = int(
            fallback_proxy_size if fallback_proxy_size is not None else 1024)
        # Seeding-phase source subsample (0 = full source): a pure-cost
        # knob (_seed_pairs docstring).
        self.seed_subsample = int(seed_subsample)
        self.mu_t = target.mean(axis=0)
        self.pct_c = torch.as_tensor(target - self.mu_t, device=self.device)
        if self.engine.icp_search_on_proxy and self.nt > proxy_size:
            self._icp_target = coreset_ops.build(
                self.pct_c, size=proxy_size, seed=self.engine.seed).points
            self._rescore = True
        else:
            self._icp_target = self.pct_c
            self._rescore = False
        self._starts = torch.as_tensor(
            start_rotations(self.engine.icp_multi_start), device=self.device)
        self._fallback_proxy = None  # built on the first fallback, shared
        self.stats = ServiceStats()

    # ------------------------------------------------------------------
    def _seed_idx(self, ns: int, point_weights) -> Optional[np.ndarray]:
        """The seeding subsample's rows: None (whole sources), [k] shared,
        or [B, k] per pair for a ragged batch (drawn over each pair's real
        rows, the prefix; a pair smaller than k tiles its rows, which
        cannot bias the seed: rescore and polish use the true weights)."""
        if not 0 < self.seed_subsample < ns:
            return None
        rng = np.random.default_rng(self.engine.seed + 7)
        if point_weights is None:
            return rng.permutation(ns)[:self.seed_subsample].astype(np.int64)
        s_sub = self.seed_subsample
        rows = []
        for wrow in point_weights:
            # Count nonzeros rather than summing, so soft weights would
            # still index only real rows.
            n_real = max(1, int(np.count_nonzero(wrow)))
            perm = rng.permutation(n_real)
            rows.append(np.tile(perm, -(-s_sub // n_real))[:s_sub])
        return np.stack(rows).astype(np.int64)

    def _seed_call(self, sources: np.ndarray, trim_keep, point_weights=None):
        """The batched seeding on the device, results copied to the host in
        one transfer.  Seeding runs at the BnB-trigger eps (0.005), not the
        coarse init eps (0.05): each pair's winner is an argmin over starts,
        and coarsely converged SSEs rank basins unreliably."""
        dev = self.device
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        seed_idx = self._seed_idx(sources.shape[1], point_weights)
        sse, R, t, scale, mu_s = _seed_pairs(
            self.pct_c, self._icp_target, f32(sources), self._starts,
            float(np.float32(self.engine.icp_convergence_bnb)),
            float(np.float32(self.engine.icp_convergence_final)),
            seed_idx=(None if seed_idx is None
                      else torch.as_tensor(seed_idx, device=dev)),
            trim_keep=trim_keep, max_iter=self.engine.icp_max_iter,
            rescore=self._rescore,
            point_weights=(None if point_weights is None
                           else f32(point_weights)))
        b = sources.shape[0]
        host = torch.cat([sse[:, None], R.reshape(b, 9), t, scale[:, None],
                          mu_s], dim=1).cpu().numpy()
        return (host[:, 0], host[:, 1:10].reshape(b, 3, 3), host[:, 10:13],
                host[:, 13], host[:, 14:17])

    def _fallback(self, source, seed_pose=None):
        """Full nested-BnB registration of one uncertified pair, sharing one
        proxy coreset of the centred target across fallbacks (GoICP
        shared_proxy) and starting from the batch's seeding pose
        (seed_pose = (R, t_centred)) instead of redoing the 15-start sweep.
        _seed_pairs centres the source by its mean, as GoICP does, so the
        centred-frame pose carries over."""
        if self._fallback_proxy is None:
            self._fallback_proxy = coreset_ops.build(
                self.pct_c, size=self.fallback_proxy_size,
                seed=self.engine.seed)
        model = GoICP(
            self.pct, source, mse_threshold=self.mse_threshold,
            engine=self.engine, trim_fraction=self.trim_fraction,
            shared_proxy=self._fallback_proxy, seed_pose_centered=seed_pose,
            device=self.device)
        R, t = model.run()
        gap, thr = model.last_certified_gap, model.sse_threshold
        certified = gap is None or gap <= thr + 1e-6 * thr
        return PairResult(
            R=np.asarray(R), t=np.asarray(t), sse=float(model.best_sse),
            mse=float(model.mse), certified=bool(certified),
            fallback_used=True)

    def register(self, sources, fallback: bool = True):
        """Register a batch of source clouds; returns [B] PairResults.

        sources: a [B, ns, 3] array (a single [ns, 3] array is a batch of
        one), a sequence or iterable of equal-size [ns, 3] clouds, or a
        RAGGED sequence of [ns_i, 3] clouds.  A ragged batch pads each cloud
        to the largest with zero-WEIGHT repeats of its first point (no point
        is discarded; the weights mask Procrustes, the SSE and the
        certificate, and each pair certifies against its own ns_i *
        mse_threshold); it cannot combine with trim_fraction.  All pairs
        seed in one batched call; pairs left uncertified run the full BnB
        one by one unless `fallback=False` (they come back certified=False).
        """
        clouds = None  # the ragged batch's clouds, as given
        weights = None
        if not isinstance(sources, np.ndarray):
            # Read an iterable once (a generator would be used up).
            sources = [np.asarray(s, np.float32) for s in sources]
            if sources and sources[0].ndim == 2 \
                    and len({s.shape[0] for s in sources}) > 1:
                clouds = sources
        if clouds is not None:
            for i, c in enumerate(clouds):
                if c.ndim != 2 or c.shape[1] != 3:
                    raise ValueError(
                        f"source {i} must be [ns, 3], got {c.shape}")
            if self.trim_fraction > 0.0:
                raise ValueError(
                    "ragged batches cannot combine with trim_fraction")
            b, ns_max = len(clouds), max(len(c) for c in clouds)
            sources = np.empty((b, ns_max, 3), np.float32)
            weights = np.zeros((b, ns_max), np.float32)
            for i, c in enumerate(clouds):
                sources[i, :len(c)] = c
                sources[i, len(c):] = c[0]
                weights[i, :len(c)] = 1.0
            ns_real = np.asarray([len(c) for c in clouds], np.float32)
        else:
            sources = np.asarray(sources, np.float32)
            if sources.ndim == 2:
                sources = sources[None]
            if sources.ndim != 3 or sources.shape[-1] != 3:
                raise ValueError(
                    f"sources must be [B, ns, 3] or a ragged sequence of "
                    f"[ns_i, 3] clouds, got {sources.shape}")
            ns_real = np.full((sources.shape[0],), sources.shape[1],
                              np.float32)
        if not np.all(np.isfinite(sources)):
            raise ValueError("source batch contains NaN/inf values")
        b, ns = sources.shape[:2]
        trim_keep = (None if self.trim_fraction <= 0.0 else
                     max(1, int(round(ns * (1.0 - self.trim_fraction)))))
        # The engine's rule is SSE <= ns * mse (fgoicp.hpp:23), for trimmed
        # runs too, so seeding certifies exactly what its fallback would.
        thr = ns_real * self.mse_threshold

        t0 = time.time()
        sse_c, R_b, t_b, scale, mu_s = self._seed_call(
            sources, trim_keep, weights)
        self.stats.seed_seconds += time.time() - t0

        # Normalized-frame SSE (module docstring) against the root-gap
        # certificate sse_norm <= ns * mse_threshold.
        sse_norm = sse_c * scale * scale
        certified = sse_norm <= thr
        results: list[PairResult] = []
        t1 = time.time()
        for i in range(b):
            if certified[i] or not fallback:
                # World frame: R (s - mu_s) + t ~ target - mu_t, so
                # t_world = t - R mu_s + mu_t.
                t_world = t_b[i] - R_b[i] @ mu_s[i] + self.mu_t
                results.append(PairResult(
                    R=R_b[i], t=t_world, sse=float(sse_norm[i]),
                    mse=float(sse_norm[i] / ns_real[i]),
                    certified=bool(certified[i]), fallback_used=False))
            else:
                source = clouds[i] if clouds is not None else sources[i]
                results.append(self._fallback(source,
                                              seed_pose=(R_b[i], t_b[i])))
        self.stats.fallback_seconds += time.time() - t1
        n_cert = int(np.sum(certified))
        self.stats.pairs += b
        self.stats.certified_by_seeding += n_cert
        self.stats.fallbacks += b - n_cert if fallback else 0
        log.debug(f"Serving batch: {b} pairs, {n_cert} certified by seeding, "
                  f"{sum(r.fallback_used for r in results)} BnB fallbacks")
        return results


def register_pairs(target, sources, mse_threshold: float = 1e-3, **kw):
    """One-shot convenience wrapper around RegistrationService."""
    srv = RegistrationService(target, mse_threshold=mse_threshold, **kw)
    return srv.register(sources)
