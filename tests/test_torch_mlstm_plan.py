"""The tensor-core mLSTM's decomposition and the RG-LRU scan's tiling, on the
CPU.

``mlstm_chunk_staged_ref`` computes the chunked mLSTM in the three stages the
Hopper kernels split it into (states, scores, outputs).  Without rounding it
is held against the reference's Pallas kernel in interpret mode at the
reference's shapes and tolerances (f32 2e-5, bf16 2e-2, as
tests/test_kernels.py); with the kernels' bfloat16 operands it is held
against the float32 plain version within ``chip_smoke.py``'s derived card
bound (rtol 1e-2 + 2^-7 of the spread), and the skipped-chunk fault that
``chip_smoke.py`` plants must fall outside that bound by at least 5x.  Also
the path each (dtype, dh, c) takes and the scratch each path allocates.  The
CUDA kernels themselves run only on the card (``chip_smoke.py``)."""
import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.ops import chunked_mlstm as ref_chunked_mlstm
from repro_torch.kernels.mlstm_chunk import ops as ML
from repro_torch.kernels.rglru import ops as RG

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_mlstm",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _log_sigmoid(x):
    return -np.logaddexp(0.0, -x).astype(np.float32)


def _inputs(B, S, H, dh, seed=5):
    """q, k, v (B, S, H, dh) and log gates li, lf (B, S, H), float32 numpy:
    the reference tests' distribution (k scaled by dh^-1/2, lf ~ logsigmoid
    of N(2, 1))."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, dh)).astype(np.float32),
            (rng.standard_normal((B, S, H, dh)) / dh ** 0.5).astype(np.float32),
            rng.standard_normal((B, S, H, dh)).astype(np.float32),
            _log_sigmoid(rng.standard_normal((B, S, H)).astype(np.float32)),
            _log_sigmoid(rng.standard_normal((B, S, H)).astype(np.float32)
                         + 2.0)]


def _heads_first(*ts):
    return [t.transpose(1, 2) for t in ts]


def _torch_args(arrs, dtype):
    tdt = DTYPES[dtype][1]
    return ([torch.from_numpy(a).to(tdt) for a in arrs[:3]]
            + [torch.from_numpy(a) for a in arrs[3:]])


MLSTM_SHAPES = [
    (2, 64, 3, 16, 16),
    (1, 96, 2, 32, 32),
    (2, 32, 4, 8, 32),     # chunk > S -> single chunk
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dh,chunk", MLSTM_SHAPES)
def test_staged_matches_the_reference_kernel(B, S, H, dh, chunk, dtype):
    arrs = _inputs(B, S, H, dh)
    jdt = DTYPES[dtype][0]
    want = ref_chunked_mlstm(*(jnp.asarray(a).astype(jdt) for a in arrs[:3]),
                             *(jnp.asarray(a) for a in arrs[3:]), chunk=chunk)
    args = _torch_args(arrs, dtype)
    got = ML.mlstm_chunk_staged_ref(*_heads_first(*args), chunk=chunk)
    got = got.transpose(1, 2)
    assert got.shape == (B, S, H, dh) and got.dtype == args[0].dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_staged_matches_the_plain_version_at_a_wider_shape():
    """Without rounding the split changes only the order of float32 sums."""
    args = _torch_args(_inputs(1, 512, 2, 128), "float32")
    hf = _heads_first(*args)
    torch.testing.assert_close(ML.mlstm_chunk_staged_ref(*hf, chunk=64),
                               ML.mlstm_chunk_ref(*hf, chunk=64),
                               rtol=2e-5, atol=2e-5)


# Reduced widths of the xlstm-1.3b card case (dh 1024, chunk 256), each
# taking the tensor-core path: (B, S, H, dh, chunk).
REDUCED = [(1, 512, 2, 128, 64), (1, 1024, 1, 256, 256), (2, 384, 2, 64, 128)]


@pytest.mark.parametrize("B,S,H,dh,chunk", REDUCED)
def test_rounded_staged_within_the_card_bound(B, S, H, dh, chunk):
    """The kernels' three bfloat16 operands keep the float32 result inside
    ``mlstm_card`` (rtol 1e-2 + 2^-7 * spread), with room to spare."""
    cs = _chip_smoke()
    args = _torch_args(_inputs(B, S, H, dh, seed=41), "bfloat16")
    assert ML.kernel_path(torch.bfloat16, dh, ML.chunk_size(S, chunk)) == "wgmma"
    want = ML.chunked_mlstm_ref(*args, chunk=chunk)
    got = ML.mlstm_chunk_staged_ref(*_heads_first(*args), chunk=chunk,
                                    rounded=True).transpose(1, 2)
    case = dict(name="mlstm_chunk", tol="mlstm_card", args=tuple(args),
                ref=functools.partial(ML.chunked_mlstm_ref, chunk=chunk))
    spread = cs.spread(case)
    assert spread.shape == want.shape and bool((spread >= 0).all())
    err, of_bound, ok = cs.compare(got, want, "mlstm_card", spread)
    assert ok and of_bound < 0.5, (err, of_bound)
    # the rounding is there: the rounded split differs from the float32 one
    assert not torch.equal(got, ML.mlstm_chunk_staged_ref(
        *_heads_first(*args), chunk=chunk).transpose(1, 2))


@pytest.mark.parametrize("B,S,H,dh,chunk", REDUCED)
def test_skipped_chunk_fault_falls_outside_the_card_bound(B, S, H, dh, chunk):
    """``chip_smoke.perturbed``'s fault (one chunk's state update skipped)
    exceeds the bound by at least 5x."""
    cs = _chip_smoke()
    args = tuple(_torch_args(_inputs(B, S, H, dh, seed=41), "bfloat16"))
    ref = functools.partial(ML.chunked_mlstm_ref, chunk=chunk)
    want = ref(*args)
    spread = cs.spread(dict(name="mlstm_chunk", tol="mlstm_card", args=args,
                            ref=ref))
    what, bad = cs.perturbed("mlstm_chunk", args, want, ref)
    assert "skipped" in what
    _, of_bound, ok = cs.compare(bad, want, "mlstm_card", spread)
    assert not ok and of_bound >= 5.0, of_bound


@pytest.mark.parametrize("dh,c,want", [
    (1024, 256, "wgmma"), (64, 64, "wgmma"), (128, 128, "wgmma"),
    (192, 192, "wgmma"), (64, 32, "simt"), (32, 64, "simt"), (96, 64, "simt"),
    (1024, 16, "simt"), (16, 16, "simt")])
def test_kernel_path(dh, c, want):
    assert ML.kernel_path(torch.bfloat16, dh, c) == want
    assert ML.kernel_path(torch.float32, dh, c) == "simt"


def test_scratch_at_the_card_shape():
    """xlstm-1.3b, B = 2 x 4096 tokens: the tensor-core path writes s in
    bf16, one float per row, and the bf16 state entering each of chunks
    1..15: 15 x 8 x 1024^2 x 2 bytes, the ~252 MB the output kernel reads
    back."""
    shapes = ML.scratch_shapes("wgmma", 2, 4, 4096, 1024, 256)
    assert shapes == {"s_buf": ((8, 16, 256, 256), torch.bfloat16),
                      "den": ((8, 4096), torch.float32),
                      "states": ((8, 15, 1024, 1024), torch.bfloat16),
                      "n_buf": ((8, 15, 1024), torch.float32)}
    nbytes = {k: int(np.prod(s)) * (2 if dt == torch.bfloat16 else 4)
              for k, (s, dt) in shapes.items()}
    assert round(nbytes["states"] / 1e6, 1) == 251.7
    assert nbytes["s_buf"] == 8 * 16 * 256 * 256 * 2


def test_scratch_of_one_chunk_and_of_the_cuda_cores():
    one = ML.scratch_shapes("wgmma", 1, 2, 128, 64, 128)
    assert one["states"] == ((2, 1, 64, 64), torch.bfloat16)
    assert one["n_buf"] == ((2, 1, 64), torch.float32)
    assert ML.scratch_shapes("simt", 2, 3, 64, 16, 16) == {
        "s_buf": ((6, 4, 16, 16), torch.float32)}


@pytest.mark.parametrize("W,block_s,block_w,want", [
    (4096, 256, 512, (128, 32)),   # recurrentgemma-9b, the card case
    (100, 32, 128, (128, 32)),     # bf16 rows of 200 bytes
    (16, 256, 512, (32, 32)),      # fewer channels than a warp
    (96, 16, 32, (32, 16)),
    (128, 64, 64, (64, 32)),
    (200, 1, 100, (128, 1))])
def test_rglru_tile(W, block_s, block_w, want):
    cw, steps = RG.tile(W, block_s, block_w)
    assert (cw, steps) == want
    assert cw % 32 == 0 and cw <= RG.MAX_TILE and 1 <= steps <= RG.MAX_STEPS
