"""The port's tools, the counterparts of the JAX package's `scripts/`, each
run as `python -m fgoicp_tpu_torch.scripts.<name>`:

* `kernel_check`: every CUDA kernel against its plain version on the card;
* `profile_phases`: the wall-clock breakdown of a registration by phase;
* `proxy_sweep`: wall and nodes over the proxy coreset size;
* `scaling_bench`: nodes/s over growing cube-axis meshes;
* `make_test_pair`: a registration pair at a known pose, with its truth;
* `visualize`: before / after panels and a convergence GIF (matplotlib);
* `step_decomp`: the pooled inner step's pieces and a full step's
  launches, host reads and device time;
* `micro_step`: the bare lane kernel against full pooled steps;
* `mxu_experiment`: `nn_min` against the norm expansion on the tensor cores;
* `minplus_experiment`: the min-plus kernel against float64 and its plain
  version, alone and in the EDT field build;
* `hard_pairs`: the trimmed turntable scan pair (bun000 / bun090 with
  --data, a seeded stand-in without);
* `serving_experiment`: ragged and trimmed fallback-heavy serving (the
  skull with --data, a seeded stand-in without).

`workloads` holds the synthetic pairs the tools run on, `timing` their
clocks and counters.
"""
