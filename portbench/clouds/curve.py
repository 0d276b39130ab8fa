"""The seeded asymmetric Lissajous curve (`gen.curve`): `points` points at
parameters uniform in [0, s_max], with Gaussian noise of standard
deviation `noise`."""

from portbench import gen


def make(rng, spec: dict):
    s = rng.uniform(0.0, float(spec["s_max"]), size=(int(spec["points"]),))
    return gen.curve(rng, s, float(spec["noise"]))
