"""Device time in kernels that are neither library products (cuBLAS) nor
the program's own kernels, a prompt token of the traced window, in
microseconds: the eager glue (norms, RoPE, copies, the MoE's routing,
gathers and combine)."""

from portbench.trace import is_port_kernel, is_product


def read(run: dict):
    t = run["traced"]
    if t is None or "calls" not in t["window"]:
        return None
    kernels = run["arch"].KERNELS
    glue = sum(secs for name, (secs, _) in t["trace"]["by_name"].items()
               if not is_product(name) and not is_port_kernel(name, kernels))
    return glue / t["window"]["tokens"] * 1e6
