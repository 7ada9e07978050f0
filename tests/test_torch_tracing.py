"""The port's spans (``repro_torch.runtime.tracing``) on the CPU: nothing
is recorded without a profiler session; under one, each step is one root
and the layers' spans nest inside it (each child's interval inside its
parent's, one step id a root); a new session starts a new recording; the
outputs are bit-equal with recording on and off; self time is a span's
duration less the union of its children's; and the device fields are None
where no span has a CUDA event."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as TF
from repro_torch.runtime import tracing
from repro_torch.runtime.tracing import Span, tally

B, S, MAX_LEN = 2, 16, 32
ARCH = {"dense": "qwen2-7b", "moe": "qwen3-moe-235b-a22b"}
#: The spans each (model, step) opens under its root.
LAYERS = {"dense": ("attention", "mlp"),
          "moe": ("attention", "moe.route", "moe.dispatch", "moe.experts",
                  "moe.combine")}
CASES = [("dense", "decode", 3), ("dense", "prefill", 2),
         ("moe", "prefill", 2), ("moe", "decode", 3)]


@pytest.fixture
def recorder(monkeypatch):
    """A fresh buffer for the test (the module keeps one per process)."""
    rec = tracing.Recorder()
    monkeypatch.setattr(tracing, "_RECORDER", rec)
    return rec


def _model(kind: str):
    cfg = reduced_config(ARCHS[ARCH[kind]])
    if kind == "moe":
        assert cfg.is_moe and cfg.moe_impl == "einsum"
    return cfg, TF.init_params(cfg, seed=0, device="cpu")


def _steps(cfg, params, step: str, n: int) -> list:
    """``n`` prefill calls or decode steps; their outputs and, for decode,
    the caches after them."""
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    if step == "prefill":
        fn = make_prefill_step(cfg)
        return [fn(params, {"tokens": toks}) for _ in range(n)]
    fn = make_decode_step(cfg)
    caches = TF.init_caches(cfg, B, MAX_LEN, device="cpu")
    index = torch.zeros(1, dtype=torch.long)
    tok, outs = toks[:, :1], []
    for _ in range(n):
        tok, logits, caches = fn(params, tok, caches, index)
        index += 1
        outs.append(logits)
    return outs + [t for c in caches for t in c.values()]


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn(*args)


def test_nothing_is_recorded_without_a_profiler(recorder):
    cfg, params = _model("dense")
    _steps(cfg, params, "decode", 2)
    _steps(cfg, params, "prefill", 1)
    assert tracing.records() == [] and tracing.totals() == {}
    assert tracing.span("mlp") is tracing.root("decode_step")


@pytest.mark.parametrize("kind,step,n", CASES)
def test_each_step_is_one_root_and_its_spans_nest(recorder, kind, step, n):
    cfg, params = _model(kind)
    _profiled(_steps, cfg, params, step, n)
    spans = tracing.records()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [f"{step}_step"] * n
    assert len({s.step for s in roots}) == n
    names = {s.name for s in spans}
    assert names == {f"{step}_step", *LAYERS[kind]}
    for i, s in enumerate(spans):
        assert s.t0 <= s.t1
        if s.parent is None:
            continue
        up = spans[s.parent]
        assert s.parent < i and up.t0 <= s.t0 and s.t1 <= up.t1
        assert s.step == up.step and up.parent is None
    t = tracing.totals()
    assert t[f"{step}_step"].count == n
    for name in LAYERS[kind]:
        assert t[name].count == n * cfg.n_layers
        assert 0 < t[name].host_self_s <= t[name].host_s
    assert all(x.device_s is None and x.device_self_s is None
               for x in t.values())
    assert tracing.totals() is t


def test_a_new_session_starts_a_new_recording(recorder):
    cfg, params = _model("dense")
    _profiled(_steps, cfg, params, "decode", 2)
    first = tracing.records()
    _steps(cfg, params, "decode", 1)
    assert tracing.records() is first and len(first) == 2 * 3
    _profiled(_steps, cfg, params, "prefill", 1)
    assert [s.name for s in tracing.records()] == [
        "prefill_step", "attention", "mlp"]
    assert tracing.totals()["prefill_step"].count == 1


@pytest.mark.parametrize("kind,step,n", CASES)
def test_outputs_are_bit_equal_with_recording_on_and_off(recorder, kind,
                                                         step, n):
    cfg, params = _model(kind)
    off = _steps(cfg, params, step, n)
    on = _profiled(_steps, cfg, params, step, n)
    assert tracing.records()
    assert len(on) == len(off)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_self_time_is_less_the_union_of_the_children():
    ms = 1_000_000
    spans = [Span("root", None, 1, 0, 100 * ms),
             Span("a", 0, 1, 10 * ms, 40 * ms),
             Span("b", 1, 1, 20 * ms, 30 * ms),
             Span("c", 0, 1, 50 * ms, 60 * ms),
             Span("c", 0, 1, 55 * ms, 70 * ms),
             Span("root", None, 2, 200 * ms, 210 * ms)]
    dev = [(0.0, 0.2), (0.01, 0.05), (0.02, 0.025), (0.06, 0.08),
           (0.07, 0.09), (0.0, 0.01)]
    host = tally(spans)
    assert {k: (t.count, round(t.host_s * 1e3, 6),
                round(t.host_self_s * 1e3, 6), t.device_s, t.device_self_s)
            for k, t in host.items()} == {"root": (2, 110, 60, None, None),
                                          "a": (1, 30, 20, None, None),
                                          "b": (1, 10, 10, None, None),
                                          "c": (2, 25, 25, None, None)}
    both = tally(spans, dev)
    assert both["root"].host_self_s == host["root"].host_self_s
    assert both["root"].device_s == pytest.approx(0.21)
    # 0.2 less (0.01..0.05) and (0.06..0.09), then all of the second root
    assert both["root"].device_self_s == pytest.approx(0.2 - 0.04 - 0.03
                                                       + 0.01)
    assert both["a"].device_self_s == pytest.approx(0.035)
    assert both["c"].device_s == pytest.approx(0.04)
    # a span whose child has no device interval has no device time
    dev[2] = None
    assert tally(spans, dev)["a"].device_s is None
