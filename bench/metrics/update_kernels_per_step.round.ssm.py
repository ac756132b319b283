"""``update_kernels_per_step.round`` in the cells that report ``round_ms.ssm``: the same
reading, under the end-to-end metric those cells move."""
from bench.harness import metric_reader

read = metric_reader("update_kernels_per_step.round")
