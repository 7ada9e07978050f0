"""Traffic kind ``prefill_batches_routed``: ``prefill_batches``, with the
MoE layers' routing judged layer by layer besides the logits.

The traffic, its parameters, the window, the logits' check and the counts
are ``prefill_batches``'s.  After the window, ``judged`` runs each judged
call's prompt through the program once more and keeps, for every MoE
layer, the input the layer took over the capacity group that ends at the
call's last token, what its held experts added there and each token's
choices (the family's ``routed_layers``).  ``check`` hands the same
inputs to the reference's layers (the family reference's ``routed``) and
adds two numbers, each the worst over the judged calls' MoE layers:

* ``routed_choices_off``: the tokens whose set of chosen experts differs
  from the reference's, where the reference's choice rests on no near tie
  (its gate scores the same input in f32, as the program's does, so
  choices may differ only there);
* ``routed_rel_l2``: the relative L2 distance of what the program's held
  experts added from what the reference's add for the program's choices,
  with the reference's weights for them and the capacity rule: the
  weights, capacity, dispatch, expert products and combine.

Ties aside, the choices are compared exactly, and the routed part alone,
so neither number depends on how much the routed experts add to the
layer's output.  A near tie that the logits' check meets in a later
layer moves those logits; it moves neither number here.  The control
(the reference in fp8) takes the program's place in both.
"""
from __future__ import annotations

import torch

from portbench import weights as W
from portbench.traffic import prefill_batches as base

setup, window, counts = base.setup, base.window, base.counts


def judged(cell, st: dict, rec: dict) -> dict:
    """``prefill_batches``'s judged calls, each with its MoE layers as the
    program ran them (``routed``)."""
    out = base.judged(cell, st, rec)
    for call in out["calls"]:
        call["routed"] = cell.arch.routed_layers(
            cell.geometry, st["cfg"], st["model"], st["step"], call["tokens"])
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp(min=1e-30))


def _off(got: torch.Tensor, want: torch.Tensor, near: torch.Tensor) -> int:
    """Tokens whose chosen sets differ, away from near ties."""
    differ = (got.sort(-1)[0] != want.sort(-1)[0]).any(-1)
    return int((differ & ~near).sum())


def check(cell, out: dict, rec: dict, launched: dict) -> dict:
    """``prefill_batches``'s numbers, and the routed layers'
    (:func:`routed`)."""
    result = base.check(cell, out, rec, launched)
    routed_check = routed(cell, out)
    for key in ("numbers", "rows", "control", "control_rows"):
        if key in routed_check:
            result[key].update(routed_check[key])
    return result


def routed(cell, out: dict) -> dict:
    """The routed layers' numbers (``numbers``), their readings by judged
    call and layer (``rows``) and, where ``cell.control``, the control's
    (``control``, ``control_rows``): one layer's weights drawn at a
    time."""
    arch, g, dev = cell.arch, cell.geometry, cell.device
    rels, offs, c_rels, c_offs = [], [], [], []
    layers = [r["layer"] for r in out["calls"][0]["routed"]] \
        if out["calls"] else []
    for j, i in enumerate(layers):
        weights = {f"layers.{i}.{k}": v for k, v in
                   W.draw_layer(arch, g, cell.seed, i, dev).items()}
        ref = arch.Reference(g, weights)
        ctl = arch.Reference(g, weights, fp8=True) if cell.control else None
        for call in out["calls"]:
            r = call["routed"][j]
            x = r["x"].float()
            want, own, near = ref.routed(i, x, r["experts"])
            rels.append(_rel(r["out"].float(), want))
            offs.append(_off(r["experts"], own, near))
            if ctl is not None:
                got, c_own, _ = ctl.routed(i, x, r["experts"])
                c_rels.append(_rel(got, want))
                c_offs.append(_off(c_own, own, near))
        del weights, ref, ctl
    result = {"numbers": {"routed_rel_l2": max(rels, default=0.0),
                          "routed_choices_off": max(offs, default=0)},
              "rows": {"routed_rel_l2": rels, "routed_choices_off": offs}}
    if cell.control:
        result["control"] = {"routed_rel_l2": max(c_rels, default=0.0),
                             "routed_choices_off": max(c_offs, default=0)}
        result["control_rows"] = {"routed_rel_l2": c_rels,
                                  "routed_choices_off": c_offs}
    return result
