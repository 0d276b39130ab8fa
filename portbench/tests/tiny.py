"""Tiny configurations of the benchmark's cells for CPU tests: the cells'
own files with point counts cut so that a run takes seconds on the CPU
(the kernels' plain versions), and a looser mse threshold for the serving
cells, whose sparse tiny clouds have a higher true-pose floor."""

from portbench import spec


def tiny(cell_name: str):
    """(bench, cell, config, mix) of a cell, cut to test size."""
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    return (bench, cell) + tiny_files(cell["config"], cell["traffic"])


def tiny_files(config_name: str, mix_name: str):
    """(config, mix) of the files of these names, cut to test size."""
    config = spec.config(config_name)
    mix = spec.traffic(mix_name)
    config["cloud"] = dict(config["cloud"], points=3000)
    config["target_points"] = 600
    config["source_points"] = 150 if config["entry"] == "register" else 200
    if config["entry"] == "service":
        config["mse_threshold"] = 1e-2
    if "batch" in mix:
        mix["batch"] = min(int(mix["batch"]), 4)
    mix.update(pool=3, trace_requests=1)
    return config, mix
