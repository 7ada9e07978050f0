"""The program under test as every family reaches it: ``repro_torch``'s
public entry points, and its kernels' build and launch counters by a
family's lists.

What is a family's own, its ``ModelConfig``, the names of its parameters
and which kernels it launches, is in ``archs/<family>.py``, which takes
the step factories and the caches from here.  ``program_spans.py`` reads
the program's spans.  Everything is imported inside the functions, so
that importing this module loads none of the program.
"""
from __future__ import annotations


def import_program() -> None:
    """Import the modules the cells drive (the program's own import)."""
    import repro_torch.launch.steps  # noqa: F401
    import repro_torch.models.convert  # noqa: F401


def make_prefill_step(cfg):
    from repro_torch.launch.steps import make_prefill_step as make

    return make(cfg)


def make_decode_step(cfg):
    from repro_torch.launch.steps import make_decode_step as make

    return make(cfg)


def init_caches(cfg, batch: int, max_len: int, device) -> list[dict]:
    from repro_torch.models.transformer import init_caches as init

    return init(cfg, batch, max_len, device=device)


def zero_launches(arch) -> None:
    for fn in arch.counters().values():
        fn.launches = 0


def launches(arch) -> dict[str, int]:
    """Launches of each of the family ``arch``'s kernels since
    :func:`zero_launches`."""
    return {name: fn.launches for name, fn in arch.counters().items()}


def build_kernels(arch, device) -> None:
    """Compile the family ``arch``'s kernels where they are missing (the
    program's build, into its directory inside the checkout)."""
    if device.type != "cuda":
        return
    from repro_torch import compat

    compat.build(list(arch.BUILD))
