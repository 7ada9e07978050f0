"""The port's K5-K7 on the CPU (their plain PyTorch versions) against the
reference Pallas kernels run in interpret mode, at the shapes and
tolerances of tests/test_kernels.py: flash attention f32 2e-5 / bf16 2e-2,
the RG-LRU scan 1e-4 / 3e-2, the chunked mLSTM 2e-5 / 2e-2 (the reference
kernel itself sits up to ~0.015 from its sequential oracle in bf16).
Inputs are made with numpy from a seed and handed to both; bfloat16 inputs
round the same float32 values in both frameworks.  The CUDA kernels
themselves run only on the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha as ref_mha
from repro.kernels.mlstm_chunk.ops import chunked_mlstm as ref_chunked_mlstm
from repro.kernels.mlstm_chunk.ref import mlstm_chunk_ref as ref_mlstm_oracle
from repro.kernels.rglru.ops import scan as ref_scan
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.mlstm_chunk import ops as ML
from repro_torch.kernels.rglru import ops as RG

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(arrs, dtype="float32"):
    """The same values as jax and torch arrays of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(np.array(a)).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _log_sigmoid(x):
    return -np.logaddexp(0.0, -x).astype(np.float32)


# -- K5 flash attention -------------------------------------------------------

FLASH_SHAPES = [
    (2, 64, 64, 4, 2, 32, True, None, 0.0),
    (1, 128, 128, 8, 8, 64, True, None, 0.0),
    (2, 96, 96, 4, 1, 32, True, 32, 0.0),      # MQA + sliding window
    (2, 48, 48, 4, 4, 32, False, None, 0.0),   # encoder
    (1, 64, 64, 2, 2, 32, True, None, 20.0),   # softcap
    (1, 100, 100, 6, 2, 16, True, None, 0.0),  # non-multiple seq
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,softcap",
                         FLASH_SHAPES)
def test_flash_attention(B, Sq, Skv, Hq, Hkv, D, causal, window, softcap,
                         dtype):
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = ref_mha(jq, jk, jv, block_q=32, block_kv=16, **kw)
    got = FA.mha(tq, tk, tv, block_q=32, block_kv=16, **kw)
    assert got.shape == (B, Sq, Hq, D) and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=_tol(dtype),
                               atol=_tol(dtype))


def test_flash_kernel_layout_and_row_blocks():
    """``flash_attention`` in (B, H, S, D) equals ``mha`` in (B, S, H, D),
    and the plain version, taken ``ROW_BLOCK`` query rows at a time, equals
    the masked softmax over all rows at once."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 70, 6, 32), (2, 70, 3, 32), (2, 70, 3, 32)))
    want = FA.mha(q, k, v, window=20, softcap=5.0)
    got = FA.flash_attention(q.transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(), window=20,
                             softcap=5.0)
    torch.testing.assert_close(got.transpose(1, 2), want, rtol=0, atol=1e-6)
    S = FA.ROW_BLOCK + 88
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, S, 4, 16), (1, S, 2, 16), (1, S, 2, 16)))
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.reshape(1, S, 2, 2, 16) / 4.0, k)
    s = torch.tanh(s / 5.0) * 5.0
    pos = torch.arange(S)
    live = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - 300)
    s = s.masked_fill(~live[None, :, None, None, :], FA.NEG_INF)
    whole = torch.einsum("bqhgk,bkhd->bqhgd", torch.softmax(s, -1), v)
    torch.testing.assert_close(
        FA.attention_ref(q, k, v, window=300, softcap=5.0),
        whole.reshape(1, S, 4, 16), rtol=0, atol=1e-6)


def test_flash_rows_without_live_keys_are_zero():
    """Shifting the queries back 8 positions masks every key of rows 0-7:
    they give 0, as the kernels do; the other rows are the causal rows
    shifted by 8."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 24, 2, 16), (1, 24, 1, 16), (1, 24, 1, 16)))
    out = FA.attention_ref(q, k, v, q_offset=-8)
    assert torch.equal(out[:, :8], torch.zeros_like(out[:, :8]))
    shifted = FA.attention_ref(q[:, 8:], k, v)
    torch.testing.assert_close(out[:, 8:], shifted, rtol=0, atol=1e-6)


def test_flash_traffic_counts_live_pairs():
    q = torch.empty((2, 4096, 28, 128), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 4096, 4, 128), dtype=torch.bfloat16, device="meta")
    t = FA.flash_attention_traffic(q, kv, kv)
    assert t["total_bytes"] == (2 * q.numel() + 2 * kv.numel()) * 2
    assert round(t["total_bytes"] / 1e6, 1) == 134.2
    assert t["flops"] == 4 * 2 * 28 * 128 * 4096 * 4097 // 2
    assert t["bytes_by_class"] == {"stream": t["total_bytes"]}
    for causal, window in ((True, None), (True, 3), (False, None), (False, 5)):
        brute = sum(1 for i in range(11) for j in range(13)
                    if (not causal or j <= i)
                    and (window is None or j > i - window))
        assert FA.live_pairs(11, 13, causal=causal, window=window) == brute


# -- K6 RG-LRU scan -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,W,bs,bw", [
    (2, 64, 96, 16, 32),
    (1, 128, 64, 64, 64),
    (3, 96, 128, 32, 128),
])
def test_rglru_scan(B, S, W, bs, bw, dtype):
    rng = np.random.default_rng(2)
    a = rng.uniform(0.6, 0.999, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    (ja, jb), (ta, tb) = _both([a, b], dtype)
    want = ref_scan(ja, jb, block_s=bs, block_w=bw)
    got = RG.scan(ta, tb, block_s=bs, block_w=bw)
    assert got.shape == (B, S, W) and got.dtype == ta.dtype
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_rglru_traffic_is_three_streams():
    a = torch.empty((4, 4096, 4096), dtype=torch.float32, device="meta")
    t = RG.rglru_scan_traffic(a, a)
    assert t["total_bytes"] == 3 * a.numel() * 4
    assert round(t["total_bytes"] / 1e6, 1) == 805.3
    assert t["flops"] == 2.0 * a.numel()
    assert t["bytes_by_class"] == {"stream": t["total_bytes"]}


# -- K7 chunked mLSTM ---------------------------------------------------------

MLSTM_SHAPES = [
    (2, 64, 3, 16, 16),
    (1, 96, 2, 32, 32),
    (2, 32, 4, 8, 32),     # chunk > S -> single chunk
]


def _mlstm_inputs(B, S, H, dh):
    rng = np.random.default_rng(5)
    return [rng.standard_normal((B, S, H, dh)).astype(np.float32),
            (rng.standard_normal((B, S, H, dh)) / dh ** 0.5).astype(np.float32),
            rng.standard_normal((B, S, H, dh)).astype(np.float32),
            _log_sigmoid(rng.standard_normal((B, S, H)).astype(np.float32)),
            _log_sigmoid(rng.standard_normal((B, S, H)).astype(np.float32)
                         + 2.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dh,chunk", MLSTM_SHAPES)
def test_mlstm_chunk_kernel(B, S, H, dh, chunk, dtype):
    arrs = _mlstm_inputs(B, S, H, dh)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs[:3], dtype)
    jli, jlf = (jnp.asarray(a) for a in arrs[3:])
    tli, tlf = (torch.from_numpy(a) for a in arrs[3:])
    want = ref_chunked_mlstm(jq, jk, jv, jli, jlf, chunk=chunk)
    got = ML.chunked_mlstm(tq, tk, tv, tli, tlf, chunk=chunk)
    assert got.shape == (B, S, H, dh) and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=_tol(dtype),
                               atol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dh,chunk", MLSTM_SHAPES)
def test_mlstm_chunk_matches_sequential_oracle(B, S, H, dh, chunk, dtype):
    """The port against the reference's strictly sequential recurrence
    (``mlstm_chunk_ref``), as tests/test_kernels.py holds the kernel."""
    arrs = _mlstm_inputs(B, S, H, dh)
    tq, tk, tv = _both(arrs[:3], dtype)[1]
    tli, tlf = (torch.from_numpy(a) for a in arrs[3:])
    got = ML.chunked_mlstm(tq, tk, tv, tli, tlf, chunk=chunk)
    want = ref_mlstm_oracle(*(jnp.asarray(_np(t)).transpose(0, 2, 1, 3)
                              for t in (tq, tk, tv)),
                            *(jnp.asarray(a).transpose(0, 2, 1)
                              for a in arrs[3:])).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(want), rtol=_tol(dtype),
                               atol=_tol(dtype))


def test_mlstm_chunk_follows_the_reference_halving():
    assert [ML.chunk_size(S, c) for S, c in
            [(96, 64), (100, 256), (4096, 256), (32, 32), (24, 64)]] == \
        [32, 100, 256, 32, 24]
    arrs = [torch.from_numpy(a) for a in _mlstm_inputs(1, 96, 2, 16)]
    heads_first = [a.transpose(1, 2) for a in arrs]
    torch.testing.assert_close(
        ML.mlstm_chunk(*heads_first, chunk=64).transpose(1, 2),
        ML.chunked_mlstm(*arrs, chunk=32), rtol=0, atol=0)


def test_mlstm_traffic_is_the_launch_geometry():
    q = torch.empty((2, 4096, 4, 1024), dtype=torch.bfloat16, device="meta")
    g = torch.empty((2, 4096, 4), dtype=torch.float32, device="meta")
    t = ML.mlstm_chunk_traffic(q, q, q, g, g, chunk=256)
    assert t["total_bytes"] == 4 * q.numel() * 2 + 2 * g.numel() * 4
    assert round(t["total_bytes"] / 1e6, 1) == 268.7
    # intra-chunk: 2·dh flops for each of the two products over the
    # c(c+1)/2 live (query, key) pairs of every chunk
    chunks = 4096 // 256
    intra = 4 * 1024 * chunks * sum(i + 1 for i in range(256))
    assert t["flops"] == 2 * 4 * (4096 * 4 * 1024 ** 2 + intra)
    assert round(t["flops"] / 1e11, 2) == 1.55
    assert t["bytes_by_class"] == {"stream": t["total_bytes"]}


# -- wrappers -------------------------------------------------------------------

def test_wrappers_reject_bad_inputs_and_count_no_cpu_launch():
    before = (FA.flash_attention.launches, RG.scan.launches,
              ML.mlstm_chunk.launches)
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="whole number"):
        FA.mha(q, kv, kv)
    with pytest.raises(ValueError, match="window"):
        FA.mha(q, q, q, window=0)
    with pytest.raises(ValueError, match="block_q"):
        FA.mha(q, q, q, block_q=0)
    with pytest.raises(ValueError, match="one .B, S, W. shape"):
        RG.scan(torch.zeros(1, 8, 4), torch.zeros(1, 8, 5))
    with pytest.raises(ValueError, match="block_s"):
        RG.scan(torch.zeros(1, 8, 4), torch.zeros(1, 8, 4), block_s=0)
    with pytest.raises(ValueError, match="gates"):
        ML.chunked_mlstm(q, q, q, torch.zeros(1, 8, 3), torch.zeros(1, 8, 4))
    with pytest.raises(ValueError, match="chunk"):
        ML.chunked_mlstm(q, q, q, torch.zeros(1, 8, 4), torch.zeros(1, 8, 4),
                         chunk=0)
    FA.mha(q, q, q)
    RG.scan(torch.zeros(1, 8, 4), torch.zeros(1, 8, 4))
    ML.chunked_mlstm(q, q, q, torch.zeros(1, 8, 4), torch.zeros(1, 8, 4))
    assert (FA.flash_attention.launches, RG.scan.launches,
            ML.mlstm_chunk.launches) == before
