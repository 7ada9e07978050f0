"""K4's share of its roofline: the bounds of its calls
(``counts.decode_attention``) over the device time of the kernels named
``decode_bulk``/``decode_merge``/``decode_split``, in percent."""

from portbench.metrics_common import roofline


def read(run: dict):
    return roofline(run, "decode_attention")
