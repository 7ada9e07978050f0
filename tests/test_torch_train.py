"""The port's train step and trainer against the reference on the CPU.

* ``make_train_step`` against the reference's jitted ``build_step(cfg,
  shape, make_host_mesh(), tcfg).fn`` over three steps, from the same
  weights (the reference's, redrawn as ``test_torch_models._perturb``
  does) and the same ``SyntheticDataset`` batches, at ``reduced_config``
  in f32: stablelm-3b with gradient compression ``none``, ``bf16`` and
  ``int8``, xlstm-1.3b with ``none``.  Each step starts from the
  reference's state before it, and its metrics (loss, ce, ``grad_norm``,
  ``lr``) and the state after it (parameters, both moments, the step) are
  compared; stablelm-3b also runs its three steps from the first state
  alone;
* ``adamw_update_`` equal to ``adamw_update`` bit for bit, for f32 and
  bf16 moments;
* the reference's ``test_e2e`` training tests on the port (the loss falls
  on a fixed batch; ten steps equal five, a stop and five resumed;
  preemption stops at the first step boundary with a checkpoint), and a
  bit-exact checkpoint of bf16 moments;
* the refusals: ``make_train_step`` on ``use_kernels=True`` and every
  model-path kernel wrapper on a tensor that requires grad.

Tolerances.  The loss, ce and ``lr`` to 1e-5 relative.  AdamW divides each
gradient by its own running magnitude, so a gradient known to ~1e-6
(stablelm-3b, ``test_torch_grads``) moves its parameter by ~1e-6 of a
step: ``grad_norm`` to 1e-5, parameters and moments to 1e-4 (measured
≤ 1.4e-6,
and ≤ 1.2e-4 for the moments under bf16 compression, where an element on
a rounding boundary of bf16 moves by one ulp, 2^-8 of itself: 1e-3
there).  xlstm-1.3b's gradients are known to 1e-3 (``test_torch_grads``:
its f32 backward amplifies rounding), so its ``grad_norm``, parameters
and first moments are held to 1e-3 and its second moments, which square
the gradient, to 2e-3 (measured ≤ 6e-4, 5.5e-5, 4.8e-4 and 1.1e-3).  The
steps take lr 1e-3: at 5e-3 xlstm-1.3b's third step, from the reference's
own state, differs by 2e-3 in ``grad_norm`` and 2.1e-3 in the second
moments, as its weights move into a region where the random model's
gradients are less well conditioned (its ``grad_norm`` runs 322, 1,362,
303 over three steps at 1e-3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.configs.shapes import ShapeSpec as RefShapeSpec
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticDataset as RefSynthetic
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import TrainConfig as RefTrainConfig
from repro.launch.steps import build_step as ref_build_step
from repro.models import transformer as REF_TF
from repro.optim import OptimizerConfig as RefOptimizerConfig
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, input_specs
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.mlstm_chunk import ops as ML
from repro_torch.kernels.rglru import ops as RG
from repro_torch.launch import train as TRAIN
from repro_torch.launch.steps import (BuiltStep, TrainConfig, build_step,
                                      make_train_step)
from repro_torch.models import transformer as TF
from repro_torch.models.convert import from_reference, load
from repro_torch.optim.adamw import (OptimizerConfig, adamw_init,
                                     adamw_update, adamw_update_)
from repro_torch.runtime import PreemptionHandler

from test_torch_models import _perturb

COMPRESSIONS = ["none", "bf16", "int8"]
STEP_CASES = [("stablelm-3b", c) for c in COMPRESSIONS] + [
    ("xlstm-1.3b", "none")]
B, S, STEPS = 2, 32, 3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=30, weight_decay=0.1)
METRIC_TOL = 1e-5
#: Relative tolerances of grad_norm and of each leaf (relative L2) of the
#: parameters and moments after a step (the module note).
STATE_TOL = {"stablelm-3b": dict(grad_norm=1e-5, params=1e-4, m=1e-4, v=1e-4),
             "xlstm-1.3b": dict(grad_norm=1e-3, params=1e-3, m=1e-3, v=2e-3)}
#: bf16 compression: the moments' floor (an element on a bf16 rounding
#: boundary moves by one bf16 ulp, 2^-8 of itself).
BF16_MOMENT_TOL = 1e-3


def _cfgs(arch):
    rcfg = dataclasses.replace(ref_reduced(REF_ARCHS[arch]), dtype="float32")
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]), dtype="float32",
                              use_kernels=False)
    return rcfg, cfg


@functools.lru_cache(maxsize=None)
def _weights(arch):
    rcfg, _ = _cfgs(arch)
    return _perturb(REF_TF.init_params(jax.random.PRNGKey(0), rcfg))


def _batches(rcfg):
    ds = RefSynthetic(rcfg, RefDataConfig(seq_len=S, batch_size=B, seed=9))
    return [ds.get_batch(i) for i in range(STEPS)]


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


@functools.lru_cache(maxsize=None)
def _reference_run(arch, compression):
    """The reference's jitted train step over ``STEPS`` batches: the state
    (parameters, optimizer state) before each step and after the last, and
    each step's metrics, all numpy (the step donates its inputs)."""
    rcfg, _ = _cfgs(arch)
    tcfg = RefTrainConfig(optimizer=RefOptimizerConfig(**OPT),
                          grad_compression=compression)
    built = ref_build_step(rcfg, RefShapeSpec("t", S, B, "train"),
                           make_host_mesh(), tcfg)
    # placed as the step places its outputs, so it compiles once
    params = jax.device_put(jax.tree.map(jnp.asarray, _weights(arch)),
                            built.in_shardings[0])
    opt = jax.device_put(ref_adamw_init(params, tcfg.optimizer),
                         built.in_shardings[1])
    states, metrics = [], []
    for batch in _batches(rcfg):
        states.append(_np((params, opt)))
        params, opt, m = built.fn(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    states.append(_np((params, opt)))
    return states, metrics


def _port_state(arch, state):
    """A reference state as the port's model and optimizer state."""
    rcfg, cfg = _cfgs(arch)
    params, opt = state
    model = load(cfg, from_reference(params, rcfg), device="cpu")
    return model, {"step": torch.tensor(int(opt["step"]), dtype=torch.int32),
                   "m": from_reference(opt["m"], rcfg),
                   "v": from_reference(opt["v"], rcfg)}


def _check_metrics(arch, got, want):
    assert sorted(got) == sorted(want)
    for k in ("loss", "ce", "grad_norm", "lr"):
        tol = STATE_TOL[arch]["grad_norm"] if k == "grad_norm" else METRIC_TOL
        assert float(got[k]) == pytest.approx(want[k], rel=tol), k


def _check_state(arch, compression, model, opt, want):
    """Parameters and moments against a reference state, per leaf."""
    rcfg, _ = _cfgs(arch)
    params, ref_opt = want
    tol = dict(STATE_TOL[arch])
    if compression == "bf16":
        for g in ("m", "v"):
            tol[g] = max(tol[g], BF16_MOMENT_TOL)
    assert int(opt["step"]) == int(ref_opt["step"])
    pairs = [({k: p.detach() for k, p in model.named_parameters()},
              from_reference(params, rcfg), tol["params"])]
    pairs += [(opt[g], from_reference(ref_opt[g], rcfg), tol[g])
              for g in ("m", "v")]
    for got, ref, tol in pairs:
        assert sorted(got) == sorted(ref)
        errs = {k: float(torch.linalg.vector_norm(got[k] - ref[k])
                         / torch.linalg.vector_norm(ref[k])) for k in ref}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= tol, (worst, errs[worst])


@pytest.mark.parametrize("arch, compression", STEP_CASES)
def test_train_step_matches_reference(arch, compression):
    """Each of three steps from the reference's state before it: the
    step's metrics and the state after it."""
    rcfg, cfg = _cfgs(arch)
    states, metrics = _reference_run(arch, compression)
    step = make_train_step(cfg, TrainConfig(optimizer=OptimizerConfig(**OPT),
                                            grad_compression=compression))
    for i, batch in enumerate(_batches(rcfg)):
        model, opt = _port_state(arch, states[i])
        model, opt, got = step(model, opt, batch)
        _check_metrics(arch, got, metrics[i])
        _check_state(arch, compression, model, opt, states[i + 1])


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_train_steps_run_free_with_the_reference(compression):
    """stablelm-3b: three steps of the port from the first state alone
    stay with the reference's three."""
    arch = "stablelm-3b"
    rcfg, cfg = _cfgs(arch)
    states, metrics = _reference_run(arch, compression)
    step = make_train_step(cfg, TrainConfig(optimizer=OptimizerConfig(**OPT),
                                            grad_compression=compression))
    model, opt = _port_state(arch, states[0])
    for batch, want in zip(_batches(rcfg), metrics):
        model, opt, got = step(model, opt, batch)
        _check_metrics(arch, got, want)
    _check_state(arch, compression, model, opt, states[-1])


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_in_place_update_equals_functional_update(state_dtype):
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          state_dtype=state_dtype)
    gen = torch.Generator().manual_seed(0)
    shapes = {"w": (16, 8), "b": (8,), "e": (4, 3, 5)}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    params["h"] = torch.randn((6, 6), generator=gen).to(torch.bfloat16)
    state = adamw_init(params, cfg)
    p_ = {k: v.clone() for k, v in params.items()}
    s_ = adamw_init(p_, cfg)
    for _ in range(4):
        grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
                 for k, v in params.items()}
        params, state, m = adamw_update(grads, state, params, cfg)
        g_ = dict(grads)
        m_, step = adamw_update_(g_, s_, p_, cfg)
        assert g_ == {}                      # each gradient dropped
        assert s_["step"] is step and int(step) == int(state["step"])
        for k in params:
            assert torch.equal(p_[k], params[k]), k
            assert s_["m"][k].dtype == getattr(torch, state_dtype)
            assert torch.equal(s_["m"][k], state["m"][k]), k
            assert torch.equal(s_["v"][k], state["v"][k]), k
        assert torch.equal(m_["grad_norm"], m["grad_norm"])
        assert torch.equal(m_["lr"], m["lr"])


# -- the reference's test_e2e on the port ------------------------------------

def _tcfg(steps=30):
    return TrainConfig(optimizer=OptimizerConfig(
        lr=5e-3, warmup_steps=2, total_steps=steps, weight_decay=0.0))


def _built(arch, seq, tcfg):
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]), use_kernels=False)
    return cfg, build_step(cfg, ShapeSpec("t", seq, 4, "train"), tcfg,
                           device="cpu")


def test_train_loss_decreases():
    tcfg = _tcfg()
    cfg, built = _built("stablelm-3b", 64, tcfg)
    ds = SyntheticDataset(cfg, DataConfig(seq_len=64, batch_size=4, seed=1))
    params = TF.init_params(cfg, seed=0, device="cpu")
    opt = adamw_init(dict(params.named_parameters()), tcfg.optimizer)
    losses = []
    for _ in range(30):
        params, opt, m = built.fn(params, opt, ds.get_batch(0))  # fixed batch
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]


def test_resume_matches_uninterrupted(tmp_path):
    """Train 10 steps; against train 5, stop, resume, train 5: the same
    loss."""
    tcfg = _tcfg(10)
    cfg, built = _built("xlstm-1.3b", 32, tcfg)
    data_cfg = DataConfig(seq_len=32, batch_size=4, seed=3)
    kw = dict(data_cfg=data_cfg, ckpt_every=100, log_every=100)

    m1 = TRAIN.train_loop(cfg, built, tcfg, steps=10,
                          ckpt_dir=str(tmp_path / "uninterrupted"),
                          preemption=PreemptionHandler(), **kw)
    d2 = str(tmp_path / "resumed")
    TRAIN.train_loop(cfg, built, tcfg, steps=5, ckpt_dir=d2,
                     preemption=PreemptionHandler(), **kw)
    m2 = TRAIN.train_loop(cfg, built, tcfg, steps=10, ckpt_dir=d2,
                          preemption=PreemptionHandler(), **kw)
    assert m2["final_step"] == 10 and m1["final_step"] == 10
    assert m1["loss"] == pytest.approx(m2["loss"], rel=1e-4)
    assert CheckpointManager(d2).all_steps() == [5, 10]


def test_preemption_checkpoints_and_stops(tmp_path):
    tcfg = _tcfg(100)
    cfg, built = _built("stablelm-3b", 32, tcfg)
    pre = PreemptionHandler()
    pre.trigger()  # preempt right after the first step
    out = TRAIN.train_loop(cfg, built, tcfg, steps=100,
                           ckpt_dir=str(tmp_path / "pre"),
                           data_cfg=DataConfig(seq_len=32, batch_size=4),
                           ckpt_every=1000, log_every=1000, preemption=pre)
    assert out["final_step"] == 1   # stopped at the first boundary
    assert CheckpointManager(str(tmp_path / "pre")).latest_step() == 1
    assert set(out) >= {"loss", "ce", "aux", "grad_norm", "lr",
                        "median_step_s", "stragglers"}


def test_bf16_moments_resume_bit_exact(tmp_path):
    """With bf16 moments the checkpointed state comes back bit for bit, and
    a resumed run continues from it."""
    tcfg = dataclasses.replace(_tcfg(4), optimizer=dataclasses.replace(
        _tcfg(4).optimizer, state_dtype="bfloat16"))
    cfg, built = _built("stablelm-3b", 32, tcfg)
    d = str(tmp_path / "bf16")
    TRAIN.train_loop(cfg, built, tcfg, steps=2, ckpt_dir=d,
                     data_cfg=DataConfig(seq_len=32, batch_size=4),
                     preemption=PreemptionHandler())
    params = TF.init_params(cfg, seed=0, device="cpu")
    like = TRAIN.train_state(params, adamw_init(
        dict(params.named_parameters()), tcfg.optimizer))
    state, step = CheckpointManager(d).restore(like)
    assert step == 2 and int(state["opt"]["step"]) == 2
    m = state["opt"]["m"]["layers.0.attn.wq.w"]
    assert m.dtype == torch.bfloat16 and bool(m.abs().sum() > 0)
    mgr = CheckpointManager(str(tmp_path / "again"))
    mgr.save(2, state)
    again, _ = mgr.restore(like)
    for group in ("m", "v"):
        for k, t in state["opt"][group].items():
            assert torch.equal(again["opt"][group][k].view(torch.int16),
                               t.view(torch.int16)), k


# -- build_step, the CLI and the refusals -------------------------------------

def test_build_step_kinds():
    cfg = dataclasses.replace(reduced_config(ARCHS["qwen2-7b"]),
                              use_kernels=False)
    for name, shape in SHAPES.items():
        built = build_step(cfg, ShapeSpec(name, 64, 2, shape.kind),
                           device="cpu")
        assert isinstance(built, BuiltStep) and built.kind == shape.kind
        assert built.device == torch.device("cpu")
        params = built.args[0]
        assert all(p.device.type == "meta" for p in params.parameters())
        specs = input_specs(cfg, ShapeSpec(name, 64, 2, shape.kind))
        if shape.kind == "train":
            assert built.args[2].keys() == specs["batch"].keys()
            assert set(built.args[1]) == {"step", "m", "v"}
            assert built.args[1]["m"].keys() == dict(
                params.named_parameters()).keys()
        elif shape.kind == "prefill":
            assert built.args[1].keys() == specs["batch"].keys()
        else:
            assert len(built.args[2]) == cfg.n_layers
            assert built.args[1].shape == (2, 1)


def test_train_step_refuses_the_kernel_path():
    cfg = reduced_config(ARCHS["stablelm-3b"])
    assert cfg.use_kernels
    with pytest.raises(ValueError, match="use_kernels=False"):
        make_train_step(cfg, TrainConfig())
    with pytest.raises(ValueError, match="use_kernels=False"):
        build_step(cfg, ShapeSpec("t", 32, 2, "train"), device="cpu")


def _grad_inputs(name):
    gen = torch.Generator().manual_seed(0)

    def t(*shape, grad=False):
        return torch.randn(shape, generator=gen).requires_grad_(grad)
    if name == "decode_attention":
        return DA.decode_attention, (t(1, 2, 2, 16, grad=True), t(1, 8, 2, 16),
                                     t(1, 8, 2, 16), 8)
    if name == "flash_attention":
        return FA.flash_attention, (t(1, 8, 2, 16, grad=True), t(1, 2, 8, 16),
                                    t(1, 2, 8, 16))
    if name == "rglru_scan":
        return RG.scan, (t(1, 8, 16).sigmoid().detach().requires_grad_(True),
                         t(1, 8, 16))
    return ML.mlstm_chunk, (t(1, 2, 8, 16, grad=True), t(1, 2, 8, 16),
                            t(1, 2, 8, 16), t(1, 2, 8), t(1, 2, 8))


@pytest.mark.parametrize("name", ["decode_attention", "flash_attention",
                                  "rglru_scan", "mlstm_chunk"])
def test_kernel_wrappers_refuse_autograd(name):
    """K4-K7 on the CPU raise where autograd records and an input requires
    grad, as on the card; under no_grad, or with no input requiring grad,
    they run their plain versions."""
    fn, args = _grad_inputs(name)
    with pytest.raises(RuntimeError, match="require grad"):
        fn(*args)
    with torch.no_grad():
        out = fn(*args)
    assert not out.requires_grad and bool(torch.isfinite(out).all())
    detached = [a.detach() if isinstance(a, torch.Tensor) else a
                for a in args]
    torch.testing.assert_close(fn(*detached), out)


def test_cli_trains_and_refuses_multi_pod(tmp_path, monkeypatch, capsys):
    argv = ["train", "--arch", "stablelm-3b", "--local", "--device", "cpu",
            "--steps", "2", "--seq-len", "16", "--batch", "2",
            "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr("sys.argv", argv)
    TRAIN.main()
    assert "[train] done:" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    # the reference's mesh choice: --local takes the host mesh whatever
    # --multi-pod says (one process: one card); the 2x16x16 production
    # mesh needs 512 ranks, and this run has 1
    monkeypatch.setattr("sys.argv", [a for a in argv if a != "--local"]
                        + ["--multi-pod"])
    with pytest.raises(SystemExit):
        TRAIN.main()
    assert "needs 512 ranks; this run has 1" in capsys.readouterr().err
