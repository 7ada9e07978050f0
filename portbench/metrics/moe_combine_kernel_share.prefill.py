"""How often the program's einsum combine ran on its kernel: launches of
kernels whose name holds ``moe_combine`` in the traced window's device
trace, over the program's ``moe.combine`` spans in that window, in
percent.  None where no ``moe.combine`` span opened, or where the spans
have no device time (the CPU)."""

from portbench.program_spans import totals
from portbench.trace import kernel_seconds


def read(run: dict):
    got = totals(run, "prefill_step", "calls")
    if got is None or "moe.combine" not in got \
            or got["moe.combine"].device_s is None:
        return None
    _, launches = kernel_seconds(run["traced"]["trace"], ("moe_combine",))
    return 100.0 * launches / got["moe.combine"].count
