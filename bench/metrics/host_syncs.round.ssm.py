"""``host_syncs.round`` in the cells that report ``round_ms.ssm``: the same
reading, under the end-to-end metric those cells move."""
from bench.harness import metric_reader

read = metric_reader("host_syncs.round")
