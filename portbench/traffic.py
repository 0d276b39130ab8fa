"""Request pools, drawn from the seed by the generator of the mix's kind.

A traffic mix is a data file, `portbench/traffic/<mix>.json`; its `kind`
names the generator that reads it, `portbench/kinds/<kind>.py` (found by
name: a new kind of traffic is a new file there), which documents its own
keys.  Keys of every mix:
* `kind`: the generator;
* `trace_requests`: the requests a traced run profiles.

The configuration's cloud (its model; a scan in a real deployment) is made
by `portbench/clouds/<cloud.kind>.py` from the configuration's own
`cloud.seed`, so every run of a configuration sees the same cloud.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import gen, spec

# Input streams of a seed.
CLOUD, TARGET, POOL, ORDER = 0, 1, 2, 4


@dataclasses.dataclass
class Request:
    sources: list            # [ns_i, 3] float32 clouds
    truths: list             # (R, t) per source: R @ source + t on the cloud
    target: Optional[np.ndarray] = None   # a pair's own target, else None


@dataclasses.dataclass
class Workload:
    target: Optional[np.ndarray]   # the views' shared target, else None
    warmup: Request
    pool: list                     # [Request], replayed in order


def model_cloud(config: dict) -> np.ndarray:
    """The configuration's cloud, fixed by its `cloud.seed`."""
    c = config["cloud"]
    return spec.cloud(c["kind"])(gen.rng_of(int(c["seed"]), CLOUD), c)


def build(config: dict, mix: dict, seed: int) -> Workload:
    """The workload of one run: the same (config, mix, seed) gives the same
    arrays."""
    return spec.kind(mix["kind"])(config, mix, seed)
