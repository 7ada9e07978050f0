"""K5's share of its roofline: the bounds of its calls
(``counts.flash_attention``) over the device time of the kernels named
``flash_wgmma``/``flash_simt`` in the trace, in percent."""

from portbench.metrics_common import roofline


def read(run: dict):
    return roofline(run, "flash_attention")
