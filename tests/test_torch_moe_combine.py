"""The MoE layer's einsum combine (``repro_torch.kernels.moe_combine``).

On the CPU: ``combine`` is the plain version, equal bit for bit to the
combine ``forward_einsum`` computed before it had a kernel (every pair's
row gathered, widened, weighted and summed over k); ``forward_einsum``
gives identical outputs with ``use_kernels`` on and off; the wrapper
refuses meta tensors, tensors that require grad and ill-formed shapes.

On the card (``-m card``; skipped without one): the kernel against the
plain version run on the card, in bf16 and f32, at the expert-parallel
prefill cell's shape (T 8,192, k 8, d 4,096, the 5,120 rows of 8 held
experts of 128 and the zero row, slots from a seeded router's
``assign`` and ``_slots``) and at tiny routed shapes: a share of the
experts (tokens whose every slot is spare), a layer that holds every
expert (no spare slot), dropped pairs (weight 0 and a spare slot) and a
width that is no whole number of the kernel's passes.  A token with at
most one live slot is equal bit for bit; others within one unit in the
last place of bfloat16 at the scale of the token's terms (the card's
plain sum adds the k slots in another order, and where they cancel the
output is near zero and its own last place far finer).  The kernel is
also its definition, bit for bit: the f32 sum in slot order; slots and
weights that are not contiguous give the same result.  Then the
refusals: the launch's own check (more slots a token than the kernel
stages) and the wrapper's (dtype, y's contiguity, width).

``chip_smoke.py`` holds the kernel to the same rule on the card; on the
CPU here, its tolerance passes the slot-order sum and fails the fault it
plants and a token of one live slot off by one unit.
"""
import dataclasses
import importlib.util
import math
import pathlib
import types

import pytest
import torch

from repro_torch import compat
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.kernels.moe_combine import ops as MC
from repro_torch.models import moe as MOE

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-moe-235b-a22b"
DTYPES = [torch.bfloat16, torch.float32]
#: Tiny routed cases: (experts held of 4, capacity factor, width).
TINY = {"share": ((0, 1), 8.0, 64), "every_expert": (None, 8.0, 64),
        "dropped": (None, 0.25, 64), "ragged_width": ((1, 3), 1.25, 2056)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def routed(cfg, held, B, S, dtype, device, seed=0):
    """(y, slot, w) as ``forward_einsum`` hands them to the combine: the
    router's ``assign`` and ``_slots`` over a seeded router (its held
    experts ``held``), and expert outputs drawn with their zero row."""
    gen = torch.Generator().manual_seed(seed)
    d, E = cfg.d_model, cfg.n_experts
    lo, hi = held or (0, E)
    p = types.SimpleNamespace(
        router=MOE.Router(torch.randn(d, E, generator=gen) / math.sqrt(d)),
        experts=(lo, hi))
    p.router.to(device)
    x = torch.randn(B, S, d, generator=gen).to(device, dtype)
    xg, weights, experts, pos, C, _ = MOE.assign(p, cfg, x, "einsum")
    keep = pos < C
    w = (weights * keep).to(dtype)
    slot = MOE._slots(p, experts, pos, keep & (w != 0), C)
    rows = (hi - lo) * xg.shape[0] * C
    y = torch.randn(rows + 1, d, generator=gen).to(device, dtype)
    y[rows] = 0
    return y, slot.contiguous(), w.contiguous()


def tiny(case, dtype, device):
    held, cf, d = TINY[case]
    cfg = dataclasses.replace(reduced_config(ARCHS[ARCH]), d_model=d,
                              capacity_factor=cf)
    return routed(cfg, held, 2, 40, dtype, device)


def before(y, slot, w):
    """The combine as ``forward_einsum`` computed it before the kernel."""
    rows = y.shape[0] - 1
    got = y.index_select(0, slot.clamp(max=rows).reshape(-1)).reshape(
        *slot.shape, y.shape[1])
    return (got.float() * w.float()[..., None]).sum(-2).to(y.dtype)


def live_slots(y, slot):
    return (slot < y.shape[0] - 1).sum(-1)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(TINY))
def test_cpu_combine_is_the_expression_before(case, dtype):
    y, slot, w = tiny(case, dtype, "cpu")
    assert torch.equal(MC.combine(y, slot, w), before(y, slot, w))


@pytest.mark.parametrize("case", list(TINY))
def test_tiny_cases_hold_what_they_name(case):
    y, slot, w = tiny(case, torch.float32, "cpu")
    live = live_slots(y, slot)
    spare = slot >= y.shape[0] - 1
    if case == "every_expert":
        assert not spare.any()
    else:
        assert spare.any()
    if case == "share":
        assert (live == 0).any() and (live > 0).any()
    if case == "dropped":
        assert ((w == 0) & spare).any()
    # a slot past the buffer adds exactly nothing
    out = MC.combine(y, slot, w)
    assert torch.equal(out[live == 0], torch.zeros_like(out[live == 0]))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("held", [(0, 2), None], ids=["share", "whole"])
def test_forward_einsum_same_with_and_without_kernels(held, dtype):
    cfg = dataclasses.replace(reduced_config(ARCHS[ARCH]),
                              dtype=str(dtype).split(".")[1])
    layer = MOE.MoE(cfg, torch.Generator().manual_seed(3), experts=held)
    layer.to(dtype)
    x = torch.randn(2, 40, cfg.d_model,
                    generator=torch.Generator().manual_seed(4)).to(dtype)
    on = MOE.forward_einsum(layer, dataclasses.replace(cfg, use_kernels=True),
                            x)
    off = MOE.forward_einsum(layer,
                             dataclasses.replace(cfg, use_kernels=False), x)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])


@pytest.mark.parametrize("held", [(0, 2), None], ids=["share", "whole"])
def test_forward_einsum_hands_the_kernel_what_it_takes(monkeypatch, held):
    """What the card's wrapper checks, seen on the CPU: a contiguous y,
    int64 slots, weights in y's dtype, the kernel path only."""
    seen = []

    def spy(y, slot, w):
        seen.append(y.is_contiguous()
                    and slot.dtype == torch.int64 and w.dtype == y.dtype
                    and y.shape[1] % (16 // y.element_size()) == 0)
        return MC.combine_ref(y, slot, w)
    monkeypatch.setattr(MOE, "combine", spy)
    cfg = reduced_config(ARCHS[ARCH])
    layer = MOE.MoE(cfg, torch.Generator().manual_seed(3), experts=held)
    x = torch.randn(2, 40, cfg.d_model).to(torch.bfloat16)
    MOE.forward_einsum(layer, cfg, x)
    MOE.forward_einsum(layer, dataclasses.replace(cfg, use_kernels=False), x)
    assert seen == [True]


def test_refuses_meta_tensors():
    y, slot, w = tiny("share", torch.bfloat16, "cpu")
    with pytest.raises(RuntimeError, match="meta or fake"):
        MC.combine(y.to("meta"), slot.to("meta"), w.to("meta"))


def test_refuses_tensors_that_require_grad():
    y, slot, w = tiny("share", torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="require grad"):
        MC.combine(y.requires_grad_(), slot, w)
    # outside grad mode nothing records, so the kernel path is allowed
    with torch.no_grad():
        assert torch.equal(MC.combine(y, slot, w), before(y, slot, w))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_moe_combine",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", list(TINY))
def test_chip_smoke_tolerance(case):
    """``chip_smoke``'s card rule on the CPU: the slot-order sum passes, the
    planted fault (every token's first slot spare) fails, and so does one
    unit's change in a token of one live slot."""
    cs = _chip_smoke()
    y, slot, w = tiny(case, torch.bfloat16, "cpu")
    want = MC.combine_ref(y, slot, w)
    spread = cs.combine_spread(y, slot, w)
    got = in_slot_order(terms(y, slot, w), y.dtype)
    assert cs.compare(got, want, "moe_combine_card", spread)[2]
    what, bad = cs.perturbed("moe_combine", (y, slot, w), want,
                             MC.combine_ref)
    assert not cs.compare(bad, want, "moe_combine_card", spread)[2], what
    one = (live_slots(y, slot) == 1).nonzero()
    if len(one):
        off = want.clone()
        at = (*one[0].tolist(), 0)
        # one unit or more in bf16's last place, or off zero
        off[at] = want[at] * (1 + 2 ** -7) if want[at] else 2 ** -20
        assert off[at] != want[at]
        assert not cs.compare(off, want, "moe_combine_card", spread)[2]


def test_chip_smoke_spread_refuses_f32():
    cs = _chip_smoke()
    with pytest.raises(cs.CheckFailed, match="bf16"):
        cs.combine_spread(*tiny("share", torch.float32, "cpu"))


def test_refuses_shapes_that_do_not_match():
    y, slot, w = tiny("share", torch.float32, "cpu")
    with pytest.raises(ValueError, match="one"):
        MC.combine(y, slot, w[..., :1])
    with pytest.raises(ValueError, match="rows"):
        MC.combine(y[None], slot, w)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def terms(y, slot, w):
    """Each pair's f32 term (..., k, d): its row widened and weighted."""
    return MC.combine_rows(y, slot).float() * w.float()[..., None]


def in_slot_order(t, dtype):
    """The terms added one by one in slot order, in f32, rounded once."""
    acc = t[..., 0, :]
    for j in range(1, t.shape[-2]):
        acc = acc + t[..., j, :]
    return acc.to(dtype)


def bf16_ulps(got, want, t):
    """The largest |got - want| in units in the last place of bfloat16 at
    the scale of the terms' absolute sum: what a change in the order of an
    f32 sum can move a rounded output by, also where the terms cancel and
    the output itself is near zero."""
    _, e = torch.frexp(t.abs().sum(-2))
    ulp = torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)
    return float(((got.float() - want.float()).abs() / ulp).max())


def hold(y, slot, w):
    """The kernel against its definition (the slot-order sum, bit for bit)
    and against the plain version on the same card tensors."""
    before_launches = MC.combine.launches
    got = MC.combine(y, slot, w)
    assert MC.combine.launches == before_launches + 1
    want = MC.combine_ref(y, slot, w)
    t = terms(y, slot, w)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, in_slot_order(t, y.dtype))
    live = live_slots(y, slot)
    one = live <= 1
    assert torch.equal(got[one], want[one])
    assert bf16_ulps(got, want, t) <= 1
    return live


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_card_cell_shape(card, dtype):
    cfg = dataclasses.replace(ARCHS[ARCH], capacity_factor=1.25)
    y, slot, w = routed(cfg, (0, 8), 2, 4096, dtype, card, seed=7)
    assert y.shape == (8 * 4 * 160 + 1, 4096) and slot.shape == (4, 2048, 8)
    live = hold(y, slot, w)
    # 8 of 128 experts: about one pair in sixteen is live
    assert 0 < int(live.sum()) <= 5120


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(TINY))
def test_card_tiny(card, case, dtype):
    y, slot, w = tiny(case, dtype, card)
    live = hold(y, slot, w)
    if case == "share":
        got = MC.combine(y, slot, w)
        assert (got[live == 0] == 0).all()


@pytest.mark.card
def test_card_slots_and_weights_not_contiguous(card):
    y, slot, w = tiny("every_expert", torch.bfloat16, card)
    # every other element of a tensor twice as wide: the same values
    strided = [torch.stack([t, t], -1)[..., 0] for t in (slot, w)]
    assert not any(t.is_contiguous() for t in strided)
    assert torch.equal(MC.combine(y, *strided), MC.combine(y, slot, w))


@pytest.mark.card
def test_card_forward_einsum_launches_once(card):
    cfg = reduced_config(ARCHS[ARCH])
    layer = MOE.MoE(cfg, torch.Generator().manual_seed(3), experts=(0, 2))
    layer.to(card)
    x = torch.randn(2, 40, cfg.d_model, device=card)
    n = MC.combine.launches
    with torch.no_grad():
        MOE.forward_einsum(layer, cfg, x)
        assert MC.combine.launches == n + 1
        MOE.forward_einsum(layer, dataclasses.replace(cfg, use_kernels=False),
                           x)
    assert MC.combine.launches == n + 1


@pytest.mark.card
def test_card_launch_check(card):
    import ctypes

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = compat.load("moe_combine", moe_combine=[i, p, p, p, p, ll, ll, i, i,
                                                  p])
    y, slot, w = tiny("share", torch.float32, card)
    out = torch.empty(80, 64, device=card)
    # 65 slots a token: past what the kernel stages
    err = lib.moe_combine(0, y.data_ptr(), slot.data_ptr(), w.data_ptr(),
                          out.data_ptr(), y.shape[0] - 1, 1, 65, 64,
                          compat.stream_ptr(y.device))
    assert err != 0
    with pytest.raises(RuntimeError, match="moe_combine"):
        compat.check_launch(err, "moe_combine")


@pytest.mark.card
def test_card_refusals(card):
    y, slot, w = tiny("share", torch.bfloat16, card)
    with pytest.raises(TypeError):
        MC.combine(y.half(), slot, w.half())
    with pytest.raises(TypeError):
        MC.combine(y, slot, w.float())
    with pytest.raises(TypeError):
        MC.combine(y, slot.int(), w)
    with pytest.raises(ValueError, match="y must be contiguous"):
        MC.combine(y.t().contiguous().t(), slot, w)
    with pytest.raises(ValueError, match="16-byte"):
        MC.combine(y[:, :60].contiguous(), slot, w)
    with pytest.raises(ValueError, match="16-byte"):
        MC.combine(y.reshape(-1)[4:4 + 64 * 50].reshape(50, 64), slot, w)
    # 65 slots a token: the launch refuses them
    wide = torch.zeros(*slot.shape[:-1], 65, dtype=torch.int64, device=card)
    with pytest.raises(RuntimeError, match="moe_combine"):
        MC.combine(y, wide, wide.to(y.dtype))
