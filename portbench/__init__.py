"""The benchmark of ``stainx_tpu_torch`` on an NVIDIA card.

``python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. See
``portbench/__main__.py``.
"""

import time

# Set-up is timed from here, the first module the command loads.
STARTED = time.perf_counter()
