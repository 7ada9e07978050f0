"""The port's serving layer (``repro_torch.launch``) against the
reference's on the CPU: the reference CLI's traffic (4 slots, max_len 128,
8 requests of 8-token prompts from numpy's seed 0, 16 new tokens each)
through both ``BatchedServer``s on the reduced qwen2-7b, recurrentgemma-9b,
xlstm-1.3b, qwen3-moe-235b-a22b, grok-1-314b and internvl2-2b in f32 with the same converted weights gives the same
tokens, and the prefill/decode clock split holds as in the reference's own
test.  Neither server resets a slot's recurrent state when it refills the
slot, so the second wave of four requests starts from the first wave's
state in both."""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.launch import serve as REF_SERVE
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as REF_TF
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.launch import serve as SERVE
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as TF
from repro_torch.models.convert import from_reference, load


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _served_tokens_equal(arch):
    rcfg = _f32(ref_reduced(REF_ARCHS[arch]))
    cfg = _f32(reduced_config(ARCHS[arch]))
    params = REF_TF.init_params(jax.random.PRNGKey(0), rcfg)
    ref = REF_SERVE.BatchedServer(rcfg, make_host_mesh(), batch_slots=4,
                                  max_len=128, params=params)
    ref_reqs = [REF_SERVE.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                for r in SERVE.cli_requests(cfg, 8, 16)]
    ref.run(ref_reqs)
    model = load(cfg, from_reference(params, rcfg), device="cpu")
    port = SERVE.BatchedServer(cfg, batch_slots=4, max_len=128, params=model,
                               device="cpu")
    reqs = port.run(SERVE.cli_requests(cfg, 8, 16))
    assert [r.generated for r in reqs] == [r.generated for r in ref_reqs]
    assert all(len(r.generated) == 16 and r.done for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
    for key in ("prefill_steps", "decode_steps", "new_tokens"):
        assert port.metrics[key] == ref.metrics[key], key


def test_served_tokens_equal_the_reference_servers():
    _served_tokens_equal("qwen2-7b")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_recurrent_served_tokens_equal_the_reference_servers(arch):
    _served_tokens_equal(arch)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b",
                                  "internvl2-2b"])
def test_moe_and_vlm_served_tokens_equal_the_reference_servers(arch):
    """The MoE decoders prefill by decode, so every served step routes
    with the sort semantics over the four slots; the VLM serves text."""
    _served_tokens_equal(arch)


def test_prefill_step_logits_match_the_forward():
    cfg = _f32(reduced_config(ARCHS["qwen2-7b"]))
    model = TF.init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12), dtype=np.int32))
    last = make_prefill_step(cfg)(model, {"tokens": toks})
    caches = TF.init_caches(cfg, 2, 12, device="cpu")
    step = make_decode_step(cfg)
    for i in range(12):
        nxt, logits, caches = step(model, toks[:, i:i + 1], caches, i)
    assert last.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), last[:, 0].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    assert torch.equal(nxt[:, 0], logits.argmax(-1).int())


def test_serve_metrics_exclude_prefill_from_decode_window():
    """run() buckets pure-prefill steps out of the decode clock: the
    tokens/sec denominator excludes steps that emit nothing.  (Accounting
    only: step() is stubbed, no model or device work.)"""
    server = object.__new__(SERVE.BatchedServer)     # skip heavy __init__
    server.pending, server.active = [], {0: None}     # one live slot
    server.metrics = {"prefill_s": 0.0, "decode_s": 0.0,
                      "prefill_steps": 0, "decode_steps": 0, "new_tokens": 0}
    script = [0, 0, 0, 2, 2, 1]                       # 3 prefill, then 5 tokens
    state = {"i": 0}

    def fake_step():
        time.sleep(1e-3)
        n = script[state["i"]]
        state["i"] += 1
        if state["i"] == len(script):
            server.active.clear()
        else:
            server.active[0] = None                   # keep the loop going
        return n

    server.step = fake_step
    server.submit = lambda r: None
    server.run([])
    m = server.metrics
    assert m["prefill_steps"] == 3 and m["decode_steps"] == 3
    assert m["new_tokens"] == 5
    assert m["prefill_s"] > 0.0 and m["decode_s"] > 0.0


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(ARCHS["qwen2-7b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SERVE.BatchedServer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(cfg, {})


def test_cli_runs_locally_on_the_cpu(capsys):
    SERVE.main(["--arch", "stablelm-3b", "--local", "--device", "cpu",
                "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.startswith("[serve] cpu: 3 requests, 12 tokens")
