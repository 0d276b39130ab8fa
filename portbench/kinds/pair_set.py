"""A fixed set of single pairs: `pool` pairs, each a fresh target
(`target_points` of the configuration's cloud) and a fresh source
(`source_points` of it, drawn independently) at a random pose, all drawn
from the mix's `set_seed`; one more pair, drawn first, is the warm-up.

The run's seed only deals the pairs to the requests in another order, so
that every seed replays the same search work (a pair's search time depends
on its pose far more than a closed loop's window can average out).

Mix keys: `set_seed`, `pool`, `shift` (translations uniform in
+-shift x span a coordinate, rotations uniform on SO(3)).
"""

from portbench import gen, traffic


def pairs(config: dict, mix: dict) -> list:
    """The warm-up pair, then the set's `pool` pairs in the order drawn."""
    cloud = traffic.model_cloud(config)
    span = gen.span_of(cloud)
    rng = gen.rng_of(int(mix["set_seed"]), traffic.POOL)
    reqs = []
    for _ in range(int(mix["pool"]) + 1):
        target = gen.subsample(rng, cloud, int(config["target_points"]))
        R, t = gen.random_pose(rng, span, float(mix["shift"]))
        src = gen.moved(gen.subsample(
            rng, cloud, int(config["source_points"])), R, t)
        reqs.append(traffic.Request([src], [(R, t)], target=target))
    return reqs


def build(config: dict, mix: dict, seed: int) -> traffic.Workload:
    warmup, *rest = pairs(config, mix)
    order = gen.rng_of(seed, traffic.ORDER).permutation(len(rest))
    return traffic.Workload(None, warmup, [rest[i] for i in order])
