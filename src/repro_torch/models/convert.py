"""The weight carrier between the reference and the port.

``from_reference`` turns the reference's parameter tree (``init_params``
output, leaves as numpy arrays) into a state dict of
:class:`~repro_torch.models.transformer.Transformer`: the reference stacks
each block of the pattern over its repeats, ``groups["b{j}"]`` with leaf
index ``g`` on the leading axis, which becomes layer ``g * len(pattern) +
j``; the unscanned ``rest`` follows in order; ``embed``, ``head``, ``ln_f``
and every bias are kept as they are.  The port's module names are the
reference's dict keys, so a leaf's path is its name.

``to_serving`` casts, once, exactly the tensors the reference casts at use
to the activation dtype: dense weights and biases, the embedding, and the
tensors a module names in ``serving_cast`` (the temporal convs, the
mLSTM's per-head maps, the MoE experts).  It leaves f32 what the
reference uses in f32: the norms, the RG-LRU's gates and ``lam``, the
sLSTM's input projection, bias and recurrent weights, and the MoE router.

An MoE model may hold a share of each layer's experts: ``from_reference``
and ``load`` take ``experts=(lo, hi)`` and keep experts lo..hi-1 of
``moe.wi``, ``moe.wg`` and ``moe.wo`` (the expert axis, after the group
index); the router stays whole.  Every product sees the same
inputs as the reference's, the weights take half the memory in bf16 (15.2
GB for qwen2-7b instead of 30.5), and no step re-casts them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import compat
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer


EXPERT_LEAVES = ("moe.wi", "moe.wg", "moe.wo")


def _flatten(tree, prefix: str, out: dict, index: int | None = None,
             experts: slice = slice(None)) -> None:
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            _flatten(val, name, out, index, experts)
        else:
            arr = np.asarray(val)
            arr = arr if index is None else arr[index]
            if name.endswith(EXPERT_LEAVES):
                arr = arr[experts]
            out[name] = torch.tensor(arr)


def from_reference(params: dict, cfg: ModelConfig, experts=None
                   ) -> dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves) as a state dict of the
    port's ``Transformer`` (CPU tensors, the reference's dtypes), holding
    experts ``lo..hi-1`` of every MoE layer for ``experts=(lo, hi)``."""
    held = slice(*experts) if experts else slice(None)
    sd: dict[str, torch.Tensor] = {}
    top = {k: v for k, v in params.items() if k not in ("groups", "rest")}
    _flatten(top, "", sd)
    n_pattern = len(cfg.block_pattern)
    for g in range(cfg.pattern_repeats):
        for j in range(n_pattern):
            _flatten(params["groups"][f"b{j}"], f"layers.{g * n_pattern + j}",
                     sd, index=g, experts=held)
    first = cfg.pattern_repeats * n_pattern
    for i, block in enumerate(params.get("rest", [])):
        _flatten(block, f"layers.{first + i}", sd, experts=held)
    return sd


def reference_path(cfg: ModelConfig, name: str) -> tuple[str, bool]:
    """(the path of the port's parameter ``name`` in the reference's tree,
    joined by ``/`` with the layer container left out, as the reference's
    sharding rules match it; whether the reference stacks that leaf over
    the scanned pattern groups' repeats)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return "/".join(parts), False
    layer = int(parts[1])
    return ("/".join(parts[2:]),
            layer < cfg.pattern_repeats * len(cfg.block_pattern))


def reference_ndim(cfg: ModelConfig, name: str, tensor: torch.Tensor) -> int:
    """The rank of the leaf ``name`` in the reference's tree: one more than
    the port's for a layer of the scanned pattern groups, which the
    reference stacks over their repeats on a leading axis (its optimizer's
    ``ndim >= 2`` rule therefore decays those layers' norms and biases)."""
    return tensor.ndim + reference_path(cfg, name)[1]


def load(cfg: ModelConfig, state_dict: dict, *, device=None,
         experts=None) -> Transformer:
    """A ``Transformer`` (holding ``experts`` of each MoE layer, default
    all) with ``state_dict`` on ``device`` (default: the CUDA card; raises
    without one).  Every parameter must be given."""
    dev = compat.resolve_device(device)
    with torch.device("meta"):
        model = Transformer(cfg, experts=experts)
    model.load_state_dict({k: v.to(dev) for k, v in state_dict.items()},
                          strict=True, assign=True)
    return model


def to_serving(model: Transformer) -> Transformer:
    """Cast what the reference casts at use (the module note) to the
    activation dtype in place, once; the rest stays f32."""
    dt = model.cfg.activation_dtype
    for mod in model.modules():
        params = (list(mod.parameters(recurse=False))
                  if isinstance(mod, L.Dense) else
                  [getattr(mod, name) for name in getattr(mod, "serving_cast", ())])
        for p in params:
            p.data = p.data.to(dt)
    if model.embed is not None:
        model.embed.data = model.embed.data.to(dt)
    return model
