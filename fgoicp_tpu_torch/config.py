"""TOML run-configuration with schema parity to the reference.

A copy of the JAX package's `fgoicp_tpu/config.py` (dataclasses and tomllib
only): importing that module would import `fgoicp_tpu/__init__.py`, which
imports jax, and this package never does.  Same keys, same defaults, same
clamps, so one TOML file drives both packages identically.

The reference parses `[io] target/source/output/visualization` and
`[params] trim/target_subsample/source_subsample/lut_resolution/mse_threshold`
with clamping rules (reference src/utilities.hpp:18-107).  The optional
`[engine]` section exposes every knob the reference hard-codes (ICP iteration
counts and thresholds, span cutoffs, batch sizes — reference
fgoicp/fgoicp.cpp:12,22,53,76,122,155) plus the engine's own settings.
Engine options this port does not run yet are accepted here and rejected by
`models.goicp.GoICP` with the ROADMAP item that ports them.

Unlike the reference, subsampling here is seeded and deterministic (the
reference uses std::random_device, utilities.hpp:149-151).
"""

from __future__ import annotations

import dataclasses
import math
import tomllib

from .utils import logging as log


def _clamp(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def _coerce_engine_value(name: str, value, default):
    """Type-checked coercion for an [engine] TOML value.

    TOML already delivers typed values; this only permits the safe
    widenings (int -> float, and exact-int floats for int fields) and
    rejects everything else — `frontier_mode = 3` must be an error, not
    the string "3"."""
    want = type(default)
    if want is bool:
        if isinstance(value, bool):
            return value
    elif want is int:
        if isinstance(value, bool):
            pass  # bool is an int subclass; reject for int fields
        elif isinstance(value, int):
            return value
        elif isinstance(value, float) and value == int(value):
            return int(value)
    elif want is float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
    elif want is str:
        if isinstance(value, str):
            return value
    raise ValueError(
        f"[engine] {name} expects {want.__name__}, got "
        f"{type(value).__name__} ({value!r})")


@dataclasses.dataclass
class IOConfig:
    target: str = ""
    source: str = ""
    output: str = ""          # result toml path ("" = skip)
    visualization: str = ""   # transformed-source ply path ("" = skip)


@dataclasses.dataclass
class Params:
    # Reference [params] schema (utilities.hpp:29-36,94-104).
    trim: bool = False
    target_subsample: float = 1.0
    source_subsample: float = 1.0
    lut_resolution: float = 0.005
    mse_threshold: float = 1e-3
    # Trimming fraction actually used when trim=True (the reference parses
    # `trim` but never implements it).
    trim_fraction: float = 0.1


@dataclasses.dataclass
class EngineConfig:
    """Knobs the reference hard-codes, plus the engine's own settings."""

    seed: int = 0
    # BnB geometry (fgoicp.cpp:36,53,113,155).
    rotation_min_span: float = 0.05
    translation_min_span: float = 0.1
    # Per-group inner-BnB batch of the grouped scheduler (not ported).
    translation_batch: int = 32
    # Rotation nodes popped from the outer queue per outer step; their (up
    # to) 8 children each run an ub-pass and an lb-pass inner BnB in one
    # pooled frontier call.
    rotation_batch: int = 16
    # Capacity of the per-group translation frontier (grouped scheduler).
    frontier_capacity: int = 4096
    # Inner-BnB scheduling: 'pooled' = one global frontier shared by all
    # rotation candidates; 'grouped' = per-group lockstep frontiers.
    frontier_mode: str = "pooled"
    # Outer SO(3) loop placement: 'host' keeps the sequential heap on the
    # host (unbounded frontier — cannot overflow); 'device' runs the whole
    # nested search as one device loop.
    outer_mode: str = "host"
    # Capacity of the device SO(3) frontier (outer_mode='device').
    so3_capacity: int = 16384
    pool_lanes: int = 1024        # nodes evaluated per pooled step
    pool_capacity: int = 32768    # pooled frontier capacity
    # Pooled frontier update: "sort" = stable argsort of the whole
    # [capacity + 8*lanes] concatenation each step; "merge" = a sorted
    # pool with binary-search merging of the children.
    pool_update: str = "sort"
    # ICP (fgoicp.cpp:12,22,76).
    icp_max_iter: int = 100
    # Lane width of batched ICP calls: triggered BnB candidates are
    # compacted into chunks of this width.  16 fits the 15-start seeding
    # sweep in one call.
    icp_width: int = 16
    icp_convergence_init: float = 0.05
    icp_convergence_bnb: float = 0.005
    icp_convergence_final: float = 0.0005
    # Cascaded seeding (models/goicp.py:_initial_icp).  Stage 1 sweeps
    # the 15 multi-starts at the reference's 5% cutoff
    # (icp_convergence_init, fgoicp.cpp:12).  If that does not certify
    # (best sse > sse_threshold), the sweep warm-restarts at
    # icp_seed_fine_conv: a 5% relative-improvement cutoff quits trimmed
    # partial-overlap ICPs on their long plateaus.  If the fine sweep still
    # does not certify, the top icp_seed_polish_width lanes re-descend as a
    # full-cloud ICP at icp_seed_polish_conv.  Certifying workloads exit
    # after stage 1 and pay nothing.
    icp_seed_fine_conv: float = 0.001
    icp_seed_polish: bool = True
    icp_seed_polish_conv: float = 1e-4
    icp_seed_polish_iters: int = 300
    icp_seed_polish_width: int = 4
    icp_trigger_factor: float = 1.8
    # Top the triggered set up to a full icp_width ICP batch with the
    # lowest-ub children: extra basin-finding attempts that break the
    # local-minimum stall where a wrong-basin incumbent starves the 1.8x
    # trigger.  Extra refinement never weakens the certificate.
    icp_refine_best: bool = True
    # Seed the incumbent from identity + the 14 multi-start rotations in
    # one batched ICP call (the reference seeds from identity only).
    icp_multi_start: bool = True
    # Search-phase ICPs (seeding + BnB triggers) iterate against the proxy
    # coreset instead of the full target; the resulting pose is re-scored
    # with one exact full-target NN pass so the incumbent stays a true
    # achievable SSE.  The final polish always uses the full target.
    icp_search_on_proxy: bool = True
    # Search-phase ICPs also iterate on a source subsample of this size
    # (0 = full source), only where it cuts the work at least 2x.  The
    # winning pose is re-scored on the full clouds, so the certificate is
    # untouched.
    icp_search_subsample: int = 2048
    # Bound math: True reproduces the reference's rotation-uncertainty
    # radius (squared point norm, unclamped half-angle,
    # registration.cu:39-43); False uses the Go-ICP paper's form (point
    # norm, half-angle clamped to pi/2).
    ref_compat_gamma: bool = False
    # Distance field of the LUT bound backend (GoICP(...,
    # bound_backend="lut"); no TOML key selects that backend).
    lut_dtype: str = "bfloat16"     # float32 | bfloat16 | float16
    lut_builder: str = "auto"       # auto | brute | edt
    lut_lookup: str = "auto"        # auto | nearest | trilinear
    lut_max_dim: int = 2048         # hard error above (registration.cu:191)
    lut_warn_dim: int = 1024        # warn above (registration.cu:195)
    lut_conservative: bool = True
    ref_compat_lut: bool = False
    # Hierarchical source bounds: when > 0 and the source has more points,
    # search-phase bound evaluation runs over this many weighted FPS
    # clusters (ops/coreset.SourceClusters) instead of every source point,
    # with the cluster radius folded into both bounds so validity is
    # preserved.  ICP and incumbent SSE always use the full source.
    # 0 = off; -1 (default) = auto: off for ns <= 2048, else
    # K = clip(2^round(log2(ns/3)), 1024, 4096).
    source_coreset: int = -1
    # Parallel layout (not ported).
    mesh_cubes: int = 1
    mesh_points: int = 1
    multihost_sync_every: int = 1
    multihost_steal_max: int = 8
    multihost_timeout_s: float = 0.0
    # Checkpoint/resume of BnB state ("" = disabled; not ported).
    checkpoint_path: str = ""
    checkpoint_every: int = 0
    # Search-state sanitizer (not ported).
    debug_checks: bool = False


@dataclasses.dataclass
class Config:
    io: IOConfig = dataclasses.field(default_factory=IOConfig)
    params: Params = dataclasses.field(default_factory=Params)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    @classmethod
    def from_toml(cls, path: str) -> "Config":
        base = path.replace("\\", "/").rsplit("/", 1)[-1]
        log.info(f"Reading configurations from {base}")
        with open(path, "rb") as f:
            tbl = tomllib.load(f)
        cfg = cls.from_dict(tbl)
        log.info(str(cfg))
        return cfg

    @classmethod
    def from_dict(cls, tbl: dict) -> "Config":
        cfg = cls()
        io_s = tbl.get("io", {})
        cfg.io.target = io_s.get("target", "")
        cfg.io.source = io_s.get("source", "")
        cfg.io.output = io_s.get("output", "")
        cfg.io.visualization = io_s.get("visualization", "")

        p = tbl.get("params", {})
        cfg.params.trim = bool(p.get("trim", False))
        cfg.params.target_subsample = float(p.get("target_subsample", 1.0))
        cfg.params.source_subsample = float(p.get("source_subsample", 1.0))
        cfg.params.lut_resolution = float(p.get("lut_resolution", 0.005))
        cfg.params.mse_threshold = float(p.get("mse_threshold", 1e-3))
        cfg.params.trim_fraction = float(p.get("trim_fraction", 0.1))

        # Reference clamps (utilities.hpp:101-104): subsamples to [1e-5, 1],
        # source further to <=0.5, mse to >=1e-12.
        cfg.params.target_subsample = _clamp(cfg.params.target_subsample, 1e-5, 1.0)
        cfg.params.source_subsample = _clamp(cfg.params.source_subsample, 1e-5, 1.0)
        cfg.params.source_subsample = _clamp(cfg.params.source_subsample, 1e-5, 0.5)
        cfg.params.mse_threshold = _clamp(cfg.params.mse_threshold, 1e-12, math.inf)
        cfg.params.trim_fraction = _clamp(cfg.params.trim_fraction, 0.0, 0.9)

        e = tbl.get("engine", {})
        known = {f.name for f in dataclasses.fields(EngineConfig)}
        for key in e:
            if key not in known:
                raise ValueError(f"Unknown [engine] key: {key!r}")
        for f in dataclasses.fields(EngineConfig):
            if f.name in e:
                setattr(cfg.engine, f.name,
                        _coerce_engine_value(f.name, e[f.name],
                                             getattr(cfg.engine, f.name)))
        return cfg

    def __str__(self) -> str:
        # Mirrors the reference's Config printer (utilities.hpp:46-58).
        return (
            "Fast Go-ICP Configurations\n"
            "\tIO Configuration:\n"
            f"\t\tTarget: {self.io.target}\n"
            f"\t\tSource: {self.io.source}\n"
            "\tParameters:\n"
            f"\t\tTrim: {'true' if self.params.trim else 'false'}\n"
            f"\t\tTarget Subsample: {self.params.target_subsample}\n"
            f"\t\tSource Subsample: {self.params.source_subsample}\n"
            f"\t\tLUT Resolution: {self.params.lut_resolution}\n"
            f"\t\tMSE Threshold: {self.params.mse_threshold}"
        )
