"""Views against one model: one target, the configuration's
`target_points` of its cloud drawn from the cloud's seed, serves every
request; each request is a batch of `batch` views, each the
configuration's `source_points` distinct rows of the cloud at a random
pose.

The views are one fixed set drawn from the mix's `set_seed`; the run's
seed only deals them to the requests in another order, so that every
seed replays the same work (views seeded into a wrong basin fall back to
the BnB and set the pace).

Mix keys: `batch`, `shift` (translations uniform in +-shift x
span a coordinate, rotations uniform on SO(3)), `set_seed`, `pool`
(requests the closed loop replays in order; one more, drawn first, is the
warm-up).
"""

from portbench import gen, traffic


def build(config: dict, mix: dict, seed: int) -> traffic.Workload:
    cloud = traffic.model_cloud(config)
    span = gen.span_of(cloud)
    target = gen.subsample(
        gen.rng_of(int(config["cloud"]["seed"]), traffic.TARGET), cloud,
        int(config["target_points"]))
    rng = gen.rng_of(int(mix["set_seed"]), traffic.POOL)
    batch = int(mix["batch"])
    views = []
    for _ in range((int(mix["pool"]) + 1) * batch):
        view = gen.subsample(rng, cloud, int(config["source_points"]))
        R, t = gen.random_pose(rng, span, float(mix["shift"]))
        views.append((gen.moved(view, R, t), (R, t)))
    warmup, rest = views[:batch], views[batch:]
    order = gen.rng_of(seed, traffic.ORDER).permutation(len(rest))
    rest = [rest[i] for i in order]
    pool = [traffic.Request([v for v, _ in rest[i:i + batch]],
                            [p for _, p in rest[i:i + batch]])
            for i in range(0, len(rest), batch)]
    return traffic.Workload(
        target, traffic.Request([v for v, _ in warmup],
                                [p for _, p in warmup]), pool)
