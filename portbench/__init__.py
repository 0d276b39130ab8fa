"""The benchmark of the PyTorch and CUDA port (`fgoicp_tpu_torch`).

One command runs one cell once, from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`BENCHMARK.json` at the root names the cells; each names a configuration
(`portbench/configs/<name>.json`, its cloud made by
`portbench/clouds/<kind>.py`), a traffic mix (`portbench/traffic/<name>.json`,
read by the generator its `kind` names, `portbench/kinds/<kind>.py`), and
the metrics, each a reader of its own (`portbench/metrics/<name>.py`).
The yardstick (generators, the plain reference, the peaks and the roofline
arithmetic, the profile reduction) lives here and imports nothing of the
program; the program is imported only by the entries
(`portbench/entries/<entry>.py`) and the run.
"""
