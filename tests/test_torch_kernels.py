"""The port's K1-K4 on the CPU (their plain PyTorch versions) against the
reference Pallas kernels run in interpret mode, at the shapes and
tolerances of tests/test_kernels.py: membench rtol 1e-6, decode attention
f32 2e-5 / bf16 2e-2.  Inputs are made with numpy from a seed and handed
to both; bfloat16 inputs round the same float32 values in both frameworks.
The CUDA kernels themselves run only on the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import gqa_decode as ref_gqa_decode
from repro.kernels.membench import ops as REF
from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.kernels.membench import ops as MB

N, BLOCK = 1 << 14, 512


def _arrays(k, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(k)]


def _both(arrs, dtype="float32"):
    """The same values as jax and torch arrays of ``dtype``."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


class TestMembench:
    @pytest.mark.parametrize("n_ga", [1, 2, 4])
    @pytest.mark.parametrize("block", [512, 2048])
    def test_aligned(self, n_ga, block):
        jx, tx = _both(_arrays(n_ga, (N,)))
        want = REF.aligned_sum(tuple(jx), block=block)
        np.testing.assert_allclose(_np(MB.aligned_sum(tx, block=block)),
                                   _np(want), rtol=1e-6)

    @pytest.mark.parametrize("delta", [1, 2, 4])
    def test_strided(self, delta):
        jx, tx = _both(_arrays(2, (N,)))
        want = REF.strided_sum(tuple(jx), delta=delta, block=BLOCK)
        got = MB.strided_sum(tx, delta=delta, block=BLOCK)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)

    def test_gather(self):
        jx, tx = _both(_arrays(3, (N,)))
        idx = np.random.default_rng(9).integers(0, N // BLOCK, 16)
        want = REF.gather_sum(tuple(jx), jnp.asarray(idx), block=BLOCK)
        got = MB.gather_sum(tx, torch.from_numpy(idx), block=BLOCK)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)

    def test_bfloat16_rounds_like_the_reference(self):
        jx, tx = _both(_arrays(2, (N,)), "bfloat16")
        want = np.asarray(REF.aligned_sum(tuple(jx), block=BLOCK))
        got = MB.aligned_sum(tx, block=BLOCK)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), want.astype(ml_dtypes.bfloat16)
                                      .astype(np.float32))

    def test_traffic_is_the_launch_geometry(self):
        _, tx = _both(_arrays(3, (N,)))
        assert MB.aligned_sum_traffic(tx) == {
            "flops": 2.0 * N, "total_bytes": 4.0 * N * 4,
            "bytes_by_class": {"stream": 4.0 * N * 4}}
        t = MB.strided_sum_traffic(tx[:2], delta=4, block=BLOCK)
        assert t["bytes_by_class"] == {"strided": 2.0 * (N // 4) * 4,
                                       "stream": (N // 4) * 4.0}
        assert t["total_bytes"] == 3.0 * (N // 4) * 4
        idx = torch.zeros(16, dtype=torch.int64)
        t = MB.gather_sum_traffic(tx, idx, block=BLOCK)
        assert t["bytes_by_class"] == {"gather": 3.0 * 16 * BLOCK * 4,
                                       "stream": 16.0 * BLOCK * 4 + 16 * 4}
        assert t["flops"] == 2.0 * 16 * BLOCK

    def test_wrappers_reject_bad_inputs_and_count_no_cpu_launch(self):
        before = (MB.aligned_sum.launches, MB.strided_sum.launches,
                  MB.gather_sum.launches)
        x = torch.zeros(N)
        with pytest.raises(ValueError, match="multiple"):
            MB.aligned_sum([torch.zeros(1000)], block=512)
        with pytest.raises(ValueError, match="1..8"):
            MB.aligned_sum([x] * 9)
        with pytest.raises(ValueError, match="one shape"):
            MB.aligned_sum([x, torch.zeros(N // 2)])
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            MB.aligned_sum([torch.zeros(N, dtype=torch.int32)])
        with pytest.raises(ValueError, match="delta"):
            MB.strided_sum([x], delta=0)
        MB.gather_sum([x], torch.zeros(4, dtype=torch.int64), block=BLOCK)
        assert (MB.aligned_sum.launches, MB.strided_sum.launches,
                MB.gather_sum.launches) == before


DECODE_SHAPES = [
    (2, 96, 8, 2, 32, 96),
    (2, 96, 8, 2, 32, 17),
    (1, 64, 4, 4, 64, 1),
    (3, 80, 16, 2, 16, 40),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,kv_len", DECODE_SHAPES)
def test_decode_attention(B, S, Hq, Hkv, D, kv_len, dtype):
    _check_decode(B, S, Hq, Hkv, D, kv_len, dtype, softcap=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,kv_len", DECODE_SHAPES)
def test_decode_attention_softcap(B, S, Hq, Hkv, D, kv_len, dtype):
    """A cap of 1.5 sits inside the scores' range (|s| up to ~4 here), so
    the tanh changes the weights."""
    _check_decode(B, S, Hq, Hkv, D, kv_len, dtype, softcap=1.5)


def _check_decode(B, S, Hq, Hkv, D, kv_len, dtype, *, softcap):
    arrs = [_arrays(1, (B, 1, Hq, D), seed=1)[0],
            _arrays(1, (B, S, Hkv, D), seed=2)[0],
            _arrays(1, (B, S, Hkv, D), seed=3)[0]]
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    want = ref_gqa_decode(jq, jk, jv, jnp.asarray(kv_len), block_s=32,
                          softcap=softcap)
    got = DA.gqa_decode(tq, tk, tv, torch.tensor(kv_len, dtype=torch.int32),
                        block_s=32, softcap=softcap)
    assert got.shape == (B, 1, Hq, D) and got.dtype == tq.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_decode_softcap_and_python_int_length():
    q, k, v = (torch.from_numpy(a) for a in (
        _arrays(1, (2, 2, 4, 32), seed=4)[0] * 4,
        _arrays(1, (2, 48, 2, 32), seed=5)[0],
        _arrays(1, (2, 48, 2, 32), seed=6)[0]))
    capped = DA.decode_attention(q, k, v, 30, softcap=5.0)
    s = torch.einsum("bhgd,bshd->bhgs", q / 32 ** 0.5, k)
    s = torch.tanh(s / 5.0) * 5.0
    s[..., 30:] = -float("inf")
    want = torch.einsum("bhgs,bshd->bhgd", torch.softmax(s, -1), v)
    torch.testing.assert_close(capped, want, rtol=2e-5, atol=2e-5)


def test_decode_traffic_counts_the_live_cache():
    q = torch.zeros(8, 1, 28, 128, dtype=torch.bfloat16)
    kc = torch.zeros(8, 64, 4, 128, dtype=torch.bfloat16)
    t = DA.gqa_decode_traffic(q, kc, kc, 40)
    cache = 2 * 8 * 40 * 4 * 128 * 2
    assert t["total_bytes"] == 2 * q.numel() * 2 + cache + 4
    assert t["bytes_by_class"] == {"stream": t["total_bytes"]}
    assert t["flops"] == 4.0 * 8 * 28 * 40 * 128
    assert DA.gqa_decode_traffic(q, kc, kc, 10_000)["total_bytes"] == \
        2 * q.numel() * 2 + 2 * 8 * 64 * 4 * 128 * 2 + 4
