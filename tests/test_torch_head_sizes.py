"""The plain versions that the Hopper kernels' head-size instances are held
to on the card, against the reference Pallas kernels run in interpret mode
at the tolerances of tests/test_kernels.py (f32 2e-5, bf16 2e-2): decode
attention at D = 256 with 16 query heads over one kv head (recurrentgemma-9b's
local attention, ``decode_bulk<256>`` on the card), and flash attention at
D = 80 (stablelm-3b, hubert-xlarge: ``flash_wgmma<80>``), causal with groups
of 2 and not causal, and at D = 256 with 16 query heads over one kv head
and a window (recurrentgemma-9b's local attention, ``flash_wgmma<256>``).  Inputs are made with numpy from a seed and handed to
both; bfloat16 inputs round the same float32 values in both frameworks.
The CUDA kernels themselves run only on the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import gqa_decode as ref_gqa_decode
from repro.kernels.flash_attention.ops import mha as ref_mha
from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.kernels.flash_attention import ops as FA

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(arrs, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 1.5])
def test_decode_at_recurrentgemma_head_size(softcap, dtype):
    """16 query heads over one kv head of 256 (one full tensor-core tile on
    the card), S 80 with 37 live rows (two whole stages and a ragged
    third); a cap of 1.5 sits inside the scores' range."""
    B, S, Hq, Hkv, D, kv_len = 2, 80, 16, 1, 256, 37
    rng = np.random.default_rng(11)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    want = ref_gqa_decode(jq, jk, jv, jnp.asarray(kv_len), block_s=32,
                          softcap=softcap)
    got = DA.gqa_decode(tq, tk, tv, torch.tensor(kv_len, dtype=torch.int32),
                        block_s=32, softcap=softcap)
    assert got.shape == (B, 1, Hq, D) and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=_tol(dtype),
                               atol=_tol(dtype))
    plain = DA.gqa_decode_ref(tq, tk, tv, kv_len, softcap=softcap)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,causal", [(4, 2, True), (4, 4, False)])
def test_flash_at_head_size_80(Hq, Hkv, causal, dtype):
    """Sq = Skv = 100 (no whole 128-row tile), D = 80: causal with two
    query heads a kv head, and not causal (an encoder).  The reference's
    kv block divides Skv: its ``mha`` pads Skv to a whole block and its
    kernel masks keys against the padded length, so a ragged Skv would let
    its non-causal rows attend to the zero keys of the padding."""
    B, S, D = 2, 100, 80
    rng = np.random.default_rng(12)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    want = ref_mha(jq, jk, jv, causal=causal, block_q=32, block_kv=20)
    got = FA.mha(tq, tk, tv, causal=causal, block_q=32, block_kv=20)
    assert got.shape == (B, S, Hq, D) and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=_tol(dtype),
                               atol=_tol(dtype))
    plain = FA.attention_ref(tq, tk, tv, causal=causal)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_at_recurrentgemma_head_size(causal, dtype):
    """D = 256, 16 query heads over one kv head, Sq = Skv = 200 and a
    window of 72: no whole 64-key tile of the card's kernel in the
    sequence, and each row's window across two or three of them.  Not
    causal, the window still bounds each row from below only."""
    B, S, Hq, Hkv, D, window = 1, 200, 16, 1, 256, 72
    rng = np.random.default_rng(13)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    kw = dict(causal=causal, window=window)
    want = ref_mha(jq, jk, jv, block_q=64, block_kv=40, **kw)
    got = FA.mha(tq, tk, tv, block_q=64, block_kv=40, **kw)
    assert got.shape == (B, S, Hq, D) and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=_tol(dtype),
                               atol=_tol(dtype))
    plain = FA.attention_ref(tq, tk, tv, **kw)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
