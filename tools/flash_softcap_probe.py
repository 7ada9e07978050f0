#!/usr/bin/env python3
"""The f32 softcap case of ``tests/test_torch_kernels_seq.py::test_flash_attention``
(B 1, S 64, 2 heads of 32, causal, cap 20, inputs from ``default_rng(0)``)
under the process states a shared test worker can leave behind, on the CPU:
``python3 tools/flash_softcap_probe.py STATE [ARG]``.

STATE is ``plain``; ``x64`` (``jax_enable_x64`` flipped on, the case run,
flipped back, as the ``x64_shim`` fixtures do); ``x64_on`` (left on);
``cache DIR`` (the reference's persistent compilation cache in DIR, minimum
compile time 0; run it twice, the second run reads the first's entries);
``threadsN`` (``torch.set_num_threads(N)``).  Prints a hash of the port's
output (``attention_ref`` through ``mha``) and of the reference's
interpret-mode Pallas kernel, and their largest difference against the
test's tolerance of 2e-5.  Run with ``JAX_PLATFORMS=cpu PYTHONPATH=src``;
``XLA_FLAGS`` may be set around it.
"""
from __future__ import annotations

import hashlib
import sys

import numpy as np


def main(argv) -> int:
    import jax
    import jax.numpy as jnp
    import torch

    from repro.kernels.flash_attention.ops import mha as ref_mha
    from repro_torch.kernels.flash_attention import ops as FA

    def case():
        rng = np.random.default_rng(0)
        arrs = [rng.standard_normal(s).astype(np.float32)
                for s in ((1, 64, 2, 32), (1, 64, 2, 32), (1, 64, 2, 32))]
        kw = dict(causal=True, window=None, softcap=20.0, block_q=32, block_kv=16)
        want = np.asarray(ref_mha(*(jnp.asarray(a) for a in arrs), **kw), np.float32)
        got = FA.mha(*(torch.from_numpy(a) for a in arrs), **kw).numpy()
        return got, want

    state = argv[0] if argv else "plain"
    if state == "x64":
        jax.config.update("jax_enable_x64", True)
        case()
        jax.config.update("jax_enable_x64", False)
    elif state == "x64_on":
        jax.config.update("jax_enable_x64", True)
    elif state == "cache":
        from repro import compat

        compat.enable_compilation_cache(argv[1])
    elif state.startswith("threads"):
        torch.set_num_threads(int(state[len("threads"):]))
    got, want = case()

    def digest(x):
        return hashlib.sha1(np.ascontiguousarray(x).tobytes()).hexdigest()[:10]

    print(f"{state}: port {digest(got)} reference {digest(want)} max diff "
          f"{float(np.abs(got - want).max()):.3g} (tolerance 2e-5); "
          f"jax_enable_x64 {jax.config.jax_enable_x64}, torch threads "
          f"{torch.get_num_threads()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
