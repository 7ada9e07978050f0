"""Sharded steps executed on a mesh of CPU ranks, held to the port's own
unsharded steps: the counterpart of the reference's
``tests/test_multidevice.py``.

Four ranks run as threads of this process (``launch.mesh.threaded_ranks``)
over a 2x2 ``("data", "model")`` mesh: one threaded run executes every
case (DTensor's sharding propagation is cached per thread, so the cases
share it), and the tests read its results.  Train steps and decode run in
f32 on the plain path.

With its default eps, AdamW's first step moves each element by about lr
times the sign of its gradient, so an element whose gradient is rounding
noise (the key bias's is zero in exact arithmetic: a per-query constant
on every score) moves either way with the order of a reduction.  The
train cases take eps 1e-3, under which the first step is linear in every
gradient below 1e-3, and start from the seed-0 weights plus N(0, 0.02^2)
noise (no leaf zero).  What the step changed is held leaf by leaf: each
first moment ((1 - b1) times the clipped gradient) to 1e-5 relative L2,
and each update (after - before) to 1e-5 of its norm plus one f32
rounding of the parameter (a norm scale near 1 moves by ~1e-3, so one
ulp of it is ~1e-4 of its update).  Measured on the 2x2 mesh, the worst
moment differs by 2.7e-6 (recurrentgemma-9b); multiplying the weights by
1 + N(0, (1.2e-7)^2), one ulp of noise, moves the unsharded gradients by
as much (``test_gradient_spread_under_one_ulp_of_the_weights``).
xlstm-1.3b's f32 gradients are only defined to ~1e-3: that ulp of noise
moves them by 2.0e-4 in the median leaf and 7.3e-4 at worst
(``layers.1.cell.wif.w``), and the sharded step, whose mLSTM runs on
value-split slices, differs by 9.4e-5 median and 4.5e-4 at worst, in the
same leaf, spread over all 84 leaves (a missing partial sum would move
its leaves by tens of percent).  Its moments and updates are held at
1e-3, its loss at 1e-5.
"""
import dataclasses

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import fake_world, init_mesh, threaded_ranks
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import OptimizerConfig, adamw_init
from repro_torch.runtime.elastic import resume_on_mesh
from repro_torch.workload.capture import fake_mode

LAYOUT = ((2, 2), ("data", "model"))
TRAIN_ARCHS = ("qwen2-7b", "qwen3-moe-235b-a22b", "recurrentgemma-9b",
               "xlstm-1.3b")
DECODE_ARCH = "command-r-35b"
B, S, DECODE_STEPS = 4, 16, 3
TCFG = ST.TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                eps=1e-3))
TOL = {"loss": 1e-5, "leaf": 1e-5, "decode": 1e-5}
LEAF_TOL = {"xlstm-1.3b": 1e-3}


def _cfg(arch):
    return dataclasses.replace(reduced_config(ARCHS[arch]), dtype="float32",
                               use_kernels=False)


def _batch(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    return {"tokens": tok, "labels": torch.roll(tok, -1, 1)}


def _train(arch, mesh=None):
    """(loss, whole parameters before and after one train step from
    seed-0 weights, the whole first moments after it, the step's state).
    After the first step each first moment is (1 - b1) times the clipped
    gradient."""
    cfg = _cfg(arch)
    built = ST.build_step(cfg, ShapeSpec("t", S, B, "train"), TCFG,
                          mesh=mesh, device="cpu")
    params = TF.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for w in params.parameters():
            w.add_(0.02 * torch.randn(w.shape, generator=g))
    before = {k: w.detach().clone() for k, w in params.named_parameters()}
    opt = adamw_init(dict(params.named_parameters()), TCFG.optimizer)
    if mesh is not None:
        ST.place_params(params, cfg, built.plan, mesh)
        opt = ST.place_opt_state(opt, params, cfg, built.plan, mesh)
    _, _, m = built.fn(params, opt, _batch(cfg, TRAIN_ARCHS.index(arch)))
    state = {"params": dict(params.named_parameters()), "opt": opt}
    return (float(m["loss"]), before, SH.gather_tree(state["params"]),
            SH.gather_tree(opt["m"]), state)


def _decode(mesh=None):
    """Logits (whole) of ``DECODE_STEPS`` steps from zero caches, and the
    caches."""
    cfg = _cfg(DECODE_ARCH)
    built = ST.build_step(cfg, ShapeSpec("d", S, B, "decode"), mesh=mesh,
                          device="cpu")
    params = TF.init_params(cfg, seed=0, device="cpu")
    caches = TF.init_caches(cfg, B, S, device="cpu")
    if mesh is not None:
        ST.place_params(params, cfg, built.plan, mesh)
        caches = ST.place_caches(caches, built.plan, mesh)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (DECODE_STEPS, B, 1), generator=g)
    out = []
    for i in range(DECODE_STEPS):
        _, logits, caches = built.fn(params, toks[i], caches,
                                     torch.tensor([i]))
        out.append(SH.gather_tree(logits))
    return torch.stack(out), caches, params


def _serve(mesh=None):
    """The tokens ``BatchedServer`` generates for three CLI requests."""
    from repro_torch.launch.serve import BatchedServer, cli_requests
    cfg = _cfg(DECODE_ARCH)
    server = BatchedServer(cfg, mesh, batch_slots=B, max_len=S,
                           device="cpu")
    return [r.generated for r in server.run(cli_requests(cfg, 3, 4))]


@pytest.fixture(scope="module")
def unsharded():
    return {"train": {a: _train(a)[:4] for a in TRAIN_ARCHS},
            "decode": _decode()[0], "serve": _serve()}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every case on the 2x2 mesh, in one threaded run; qwen2-7b's trained
    state is checkpointed (rank 0 writes, every rank gathers)."""
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))

    def rank(r):
        mesh = init_mesh(*LAYOUT, device_type="cpu")
        out = {"train": {}}
        for arch in TRAIN_ARCHS:
            *got, state = _train(arch, mesh)
            out["train"][arch] = tuple(got)
            if arch == "qwen2-7b":
                CheckpointManager(ckpt_dir).save(1, state)
                out["local"] = {
                    k: (tuple(v.to_local().shape), tuple(v.placements),
                        v.to_local().clone())
                    for k, v in state["params"].items()}
                out["opt"] = SH.gather_tree(state["opt"])
        logits, caches, _ = _decode(mesh)
        out["decode"] = logits
        out["serve"] = _serve(mesh)
        out["cache_local"] = [(tuple(c["k"].to_local().shape),
                               tuple(c["k"].placements)) for c in caches]
        return out
    return threaded_ranks(4, rank), ckpt_dir


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _update_err(p1, p0, before, tol) -> float:
    """The gap between two updates of ``before`` over what it may be:
    ``tol`` of the update's norm plus one f32 rounding of the parameter
    (at most eps |p| an element)."""
    nrm = torch.linalg.vector_norm
    allowed = (tol * nrm(p0 - before)
               + torch.finfo(torch.float32).eps * nrm(p0))
    return float(nrm((p1 - before) - (p0 - before)) / allowed)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_equals_unsharded(arch, sharded, unsharded):
    """The loss, and leaf by leaf what the step changed: each parameter's
    update (after - before) and each first moment (the clipped gradient
    times 1 - b1), against the unsharded step's."""
    ranks, _ = sharded
    loss0, before, p0, m0 = unsharded["train"][arch]
    tol = LEAF_TOL.get(arch, TOL["leaf"])
    for out in ranks:
        loss1, before1, p1, m1 = out["train"][arch]
        assert loss1 == pytest.approx(loss0, rel=TOL["loss"])
        assert sorted(p1) == sorted(p0) == sorted(m1) == sorted(before)
        for k in before:
            assert torch.equal(before1[k], before[k]), k
        for what, errs in (
                ("update", {k: _update_err(p1[k], p0[k], before[k], tol)
                            for k in p0}),
                ("moment", {k: _rel(m1[k], m0[k]) / tol for k in m0})):
            worst = max(errs, key=errs.get)
            assert errs[worst] <= 1.0, (what, worst, errs[worst] * tol)


def test_gradient_spread_under_one_ulp_of_the_weights(unsharded,
                                                      monkeypatch):
    """The reading behind the bounds: one ulp of noise on the weights
    moves qwen2-7b's gradients by ~1e-6 and xlstm-1.3b's by ~1e-4 in the
    median leaf, inside the 1e-3 it is held to."""
    init = TF.init_params

    def noisy(cfg, seed, device):
        params = init(cfg, seed=seed, device=device)
        g = torch.Generator().manual_seed(99)
        with torch.no_grad():
            for w in params.parameters():
                w.mul_(1 + 1.2e-7 * torch.randn(w.shape, generator=g))
        return params
    monkeypatch.setattr(TF, "init_params", noisy)
    for arch, lo, hi in (("qwen2-7b", 0.0, TOL["leaf"]),
                         ("xlstm-1.3b", 1e-4, LEAF_TOL["xlstm-1.3b"])):
        m0 = unsharded["train"][arch][3]
        m1 = _train(arch)[3]
        errs = sorted(_rel(m1[k], m0[k]) for k in m0)
        assert lo <= errs[len(errs) // 2] and errs[-1] <= hi, (arch, errs)


def test_sharded_decode_logits_equal_unsharded(sharded, unsharded):
    """command-r-35b: three decode steps' logits over the real vocabulary,
    on every rank."""
    ranks, _ = sharded
    v = _cfg(DECODE_ARCH).vocab_size        # the padding columns are -1e30
    want = unsharded["decode"][..., :v]
    for out in ranks:
        assert _rel(out["decode"][..., :v], want) <= TOL["decode"]


def test_sharded_server_generates_the_unsharded_tokens(sharded, unsharded):
    """``BatchedServer(cfg, mesh)``: the reference's plan for its slots,
    weights and caches placed by it; the same tokens on every rank."""
    ranks, _ = sharded
    assert all(len(g) == 4 for g in unsharded["serve"])
    for out in ranks:
        assert out["serve"] == unsharded["serve"]


def test_leaves_are_really_sharded(sharded):
    """Each rank holds a quarter of an FSDP + tensor-parallel matrix, its
    own quarter, and a half of each batch-split kv cache."""
    from torch.distributed.tensor import Shard
    ranks, _ = sharded
    cfg = _cfg("qwen2-7b")
    shape, place, _ = ranks[0]["local"]["layers.0.mlp.wi.w"]
    assert place == (Shard(0), Shard(1))
    assert shape == (cfg.d_model // 2, cfg.d_ff // 2)
    chunks = [out["local"]["layers.0.mlp.wi.w"][2] for out in ranks]
    assert not any(torch.equal(chunks[0], c) for c in chunks[1:])
    dcfg = _cfg(DECODE_ARCH)
    for out in ranks:
        kshape, kplace = out["cache_local"][0]
        assert kplace == (Shard(0), Shard(2))
        assert kshape == (B // 2, S, dcfg.n_kv_heads // 2, dcfg.head_dim)


def test_checkpoint_resumes_on_another_mesh(sharded):
    """qwen2-7b's state saved from 2x2 restored onto 4x1 through
    ``resume_on_mesh``: bit for bit, placed by the 4x1 plan."""
    from torch.distributed.tensor import Replicate, Shard
    ranks, ckpt_dir = sharded
    cfg = _cfg("qwen2-7b")
    shape = ShapeSpec("t", S, B, "train")

    def rank(r):
        mesh = init_mesh((4, 1), ("data", "model"), device_type="cpu")
        built = ST.build_step(cfg, shape, TCFG, mesh=mesh, device="cpu")
        params = TF.init_params(cfg, seed=1, device="cpu")
        opt = adamw_init(dict(params.named_parameters()), TCFG.optimizer)
        like = {"params": dict(params.named_parameters()), "opt": opt}
        place = {"params": built.shardings["params"],
                 "opt": dict(built.shardings["opt"], step=None)}
        state, step = resume_on_mesh(CheckpointManager(ckpt_dir), like,
                                     mesh, place)
        return step, {k: (v.full_tensor(), tuple(v.placements),
                          tuple(built.shardings["params"][k]))
                      for k, v in state["params"].items()}, \
            SH.gather_tree(state["opt"])
    step, params, opt = threaded_ranks(4, rank)[0]
    want = ranks[0]["train"]["qwen2-7b"][2]
    assert step == 1 and sorted(params) == sorted(want)
    for k, (t, place, plan) in params.items():
        assert torch.equal(t, want[k]), k
        assert place == plan, k
    for g in ("m", "v"):
        for k, t in opt[g].items():
            assert torch.equal(t, ranks[0]["opt"][g][k]), (g, k)
    assert int(opt["step"]) == int(ranks[0]["opt"]["step"]) == 1
    # 4x1: FSDP over the 4 data ranks (the model axis has size 1)
    assert params["layers.0.mlp.wi.w"][1][0] == Shard(0)
    assert params["layers.0.ln1.scale"][1] == (Replicate(), Replicate())


def test_a_mesh_refuses_the_kernels():
    """With a mesh of more than one rank ``use_kernels=True`` raises, at
    ``build_step`` and in the model code; a 1x1 mesh builds."""
    cfg = dataclasses.replace(_cfg("qwen2-7b"), use_kernels=True)
    shape = ShapeSpec("p", S, B, "prefill")
    with fake_world(4):
        mesh = init_mesh(*LAYOUT, device_type="cpu")
        with pytest.raises(ValueError, match="plain path"):
            ST.build_step(cfg, shape, mesh=mesh, device="cpu")
        plain = dataclasses.replace(cfg, use_kernels=False)
        built = ST.build_step(plain, shape, mesh=mesh, device="cpu")
        with fake_mode():
            params = TF.Transformer(cfg, device="cpu")
            ST.place_params(params, cfg, built.plan, mesh)
            batch = ST.place_batch({"tokens": torch.zeros(
                (B, S), dtype=torch.int64)}, built.plan, mesh)
            with pytest.raises(ValueError, match="kernels run on one card"):
                ST.make_prefill_step(cfg, mesh, built.plan)(params, batch)
    with fake_world(1):
        one = init_mesh((1, 1), ("data", "model"), device_type="cpu")
        assert ST.build_step(cfg, shape, mesh=one, device="cpu").plan \
            is not None


def test_threaded_ranks_raise_the_first_error_and_leave_no_group():
    import torch.distributed as dist

    def rank(r):
        if r == 1:
            raise KeyError("rank 1")
        dist.barrier()
        return r
    with pytest.raises(KeyError, match="rank 1"):
        threaded_ranks(2, rank)
    assert not dist.is_initialized()
    assert threaded_ranks(2, lambda r: r * 10) == [0, 10]


def test_choose_mesh_builds_the_mesh_on_the_device_asked(monkeypatch):
    """``launch.train.choose_mesh`` under four ranks with ``--device cpu``:
    the host mesh is a 2x2 CPU mesh, and the production mesh raises with
    the ranks it needs; with no device named and no card, it raises
    rather than falling back to the CPU."""
    from repro_torch.launch.train import choose_mesh
    monkeypatch.setenv("WORLD_SIZE", "4")

    def rank(r):
        mesh = choose_mesh(local=True, multi_pod=False, device="cpu")
        with pytest.raises(RuntimeError, match="needs 256 ranks; this run "
                           "has 4"):
            choose_mesh(local=False, multi_pod=False, device="cpu")
        refused = None
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device") as e:
                choose_mesh(local=True, multi_pod=False)
            refused = str(e.value)
        return (mesh.device_type, tuple(mesh.shape), mesh.mesh_dim_names,
                refused)
    for got in threaded_ranks(4, rank):
        assert got[:3] == ("cpu", (2, 2), ("data", "model"))
