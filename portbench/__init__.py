"""The benchmark of `frenetix_tpu_torch`, the PyTorch and CUDA port, on one
NVIDIA H100.  `python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of BENCHMARK.json once.

Each configuration, traffic mix, comparison limit and per-layer metric is a
file of its own, found by the name BENCHMARK.json gives it
(`configs/<config>.json`, `traffic/<traffic>.json`, `limits/<config>.json`,
`metrics/<metric>.py`); a configuration names the entry that drives the
program (`entries/<entry>.py`), and may name a generator of its own
(`generators/<name>.py`) and a check of its own (`checks/<name>.py`).
`reference/` is the plain reference the
answers are held to; nothing in this package imports JAX or the JAX
package.
"""
