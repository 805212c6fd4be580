"""stats_device_ms.hm (ms), kernels: ``stats_device_ms`` in the
histogram-matching cell, read by the same reader
(``metrics/stats_device_ms.py``): the device interval of the program's
``stainx.stats`` spans per call in the traced stretch, there B8a and its
LUT finalize. It is listed apart because ``stats_device_ms`` lists the
Reinhard cell alone, as ``test_portbench_reinhard.py`` holds it. A program
without the span gives nothing to read."""

from portbench import spec


def read(run):
    return spec.load_module("metrics", "stats_device_ms").read(run)
