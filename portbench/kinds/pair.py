"""Single pairs: each request a fresh target (`target_points` of the
configuration's cloud) and a fresh source (`source_points` of it, drawn
independently) at a random pose, all drawn from the run's seed.

Mix keys: `shift` (translations uniform in +-shift x span a coordinate,
rotations uniform on SO(3)); `pool` (requests the closed loop replays in
order; one more, drawn first, is the warm-up).
"""

from portbench import gen, traffic


def build(config: dict, mix: dict, seed: int) -> traffic.Workload:
    cloud = traffic.model_cloud(config)
    span = gen.span_of(cloud)
    rng = gen.rng_of(seed, traffic.POOL)
    reqs = []
    for _ in range(int(mix["pool"]) + 1):
        target = gen.subsample(rng, cloud, int(config["target_points"]))
        R, t = gen.random_pose(rng, span, float(mix["shift"]))
        src = gen.moved(gen.subsample(
            rng, cloud, int(config["source_points"])), R, t)
        reqs.append(traffic.Request([src], [(R, t)], target=target))
    return traffic.Workload(None, reqs[0], reqs[1:])
