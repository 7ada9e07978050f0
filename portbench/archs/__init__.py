"""Model families, one module each: ``archs/<family>.py``.

A configuration file names its family in ``architecture.family``; a file
that names none belongs to ``qwen`` (:data:`DEFAULT`).  The harness loads
the module by that name (``harness.Layout.arch``), as it loads a traffic
kind, and hands it to the traffic kinds as ``cell.arch``: they reach the
program, the weight draw, the reference and the counts only through it.
A new architecture goes in as a new module here (with its reference
under ``reference/`` where it wants one), a configuration that names it,
and its cells: no file of the harness changes.

A family module provides:

* ``geometry(cfg)``: the configuration file as the family's own frozen
  record, with at least ``name``, ``n_layers``, ``vocab``,
  ``padded_vocab`` and ``is_moe``.  Every other function takes it as
  ``g``.
* The draw plan, which ``weights.draw_weights`` draws from the seed:
  ``layer_leaves(g, i)``, the leaves of layer ``i``, and
  ``top_leaves(g)``, each a list of ``(name, shape, dtype, (how,
  scale))``.
* ``Reference(g, weights, fp8=False)``: the plain f32 reference on the
  drawn leaves (TF32 off, ``reference.exact_matmuls``), with ``fp8=True``
  the control.  It imports nothing of the program and nothing of JAX.
  ``prefill_last(tokens)`` -> (last-position logits (B, vocab), kept
  expert pairs); ``decode_chunk(tokens, start, prefix_of)`` -> (logits
  (R, n, vocab), the rows of each layer's cache tensors that the ``n``
  steps write, in ``cache_leaves`` order), where ``prefix_of(layer)``
  gives ``(first, rows)``: the layer's cache rows of positions
  ``first``..``start - 1``.  Where the kind sets ``margins`` to a list,
  an MoE reference may append each row's router margin to it.
* The adapter to the program: ``model_config(g)``; ``load_model(g, cfg,
  weights, device)``, the drawn leaves under the program's names;
  ``make_prefill_step(cfg)``, ``make_decode_step(cfg)`` and
  ``init_caches(cfg, batch, max_len, device)``; ``cache_leaves(g, layer,
  batch, max_len)``, the ``(name, shape, tag)`` of each cache tensor of a
  layer that the decode kind fills from the seed and rebuilds.  Rows are
  a cache tensor's dimension 1, and position ``p`` lives in row ``p %
  rows`` (a ring where the tensor holds fewer rows than ``max_len``).
* Counts, from the configuration and never from the program:
  ``prefill_call(g, batch, seq, kept)`` and ``decode_step(g, batch,
  index)``, each ``{"flops", "bytes", "bound_s", ...}`` (``counts.bound_s``
  over the card's peaks); ``kernel_bounds(g, phase, batch, n)``, the
  bound seconds of each kernel over every layer of one ``prefill`` call
  of ``batch`` x ``n`` or one ``decode`` step at position ``n``.
* Kernels: ``KERNELS``, the program's kernels by name, each a tuple of
  fragments of its device names (the roofline and glue readers match
  the trace with them); ``LAUNCH_CHECKS``, the compared number of each
  kernel's launches; ``BUILD``, what the program builds
  (``compat.build``); ``counters()``, each kernel's wrapper, whose
  ``launches`` the harness zeroes and reads; ``expected_launches(g,
  phase, n)``, each kernel's launches in ``n`` prefill calls or decode
  steps on the card.
"""

#: The family of a configuration file that names none.
DEFAULT = "qwen"
