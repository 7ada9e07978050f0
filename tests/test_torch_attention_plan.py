"""The Hopper attention kernels' host-side plans, on the CPU: which kernel
each (dtype, head size) takes in both wrappers, how decode attention deals
the cache to splits (whole stages, an exact cover of [0, S), whole waves of
an H100's 132 SMs), how many kv heads a bulk-copy CTA covers, and the
build phase's count of Hopper instructions in a kernel's SASS.  The kernels
themselves run only on the card (``chip_smoke.py``)."""
import importlib.util
import math
import pathlib

import pytest
import torch

from repro_torch import compat
from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.kernels.flash_attention import ops as FA

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100_SMS = 132


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", FA.HEAD_DIMS)
def test_flash_path(dtype, D):
    want = "wgmma" if dtype == torch.bfloat16 and D >= 64 else "simt"
    assert FA.kernel_path(dtype, D) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", DA.HEAD_DIMS)
def test_decode_path(dtype, D):
    want = "bulk" if dtype == torch.bfloat16 and D in (64, 128) else "simt"
    assert DA.kernel_path(dtype, D) == want


# (S, CTAs per split, CTAs per SM): qwen2-7b decode (B = 8, one CTA over
# its 4 kv heads), the same at kv_len 32,000 and at B = 1, a ragged S, and
# the CUDA-core path's grid of B * Hkv * head chunks at 8 CTAs per SM.
PLANS = [(32768, 8, 1), (32000, 8, 1), (32768, 1, 1), (4000, 8, 1),
         (32768, 32, 8), (96, 4, 8), (1, 8, 1)]


@pytest.mark.parametrize("S,ctas,per_sm", PLANS)
def test_decode_plan_covers_the_cache_in_whole_stages(S, ctas, per_sm):
    n_split, n_stages = DA._plan(S, ctas, H100_SMS, per_sm)
    assert n_stages == -(-S // DA.STAGE_ROWS)
    assert 1 <= n_split <= n_stages
    rows = DA.split_rows(n_split, n_stages, S)
    assert rows[0][0] == 0 and rows[-1][1] == S
    for (lo, hi), (nxt, _) in zip(rows, rows[1:]):
        assert hi == nxt and lo % DA.STAGE_ROWS == 0 and hi % DA.STAGE_ROWS == 0
    sizes = [hi - lo for lo, hi in rows]
    assert min(sizes) > 0
    # whole stages, balanced to one stage (the last may be ragged at S)
    stages = [-(-(hi - lo) // DA.STAGE_ROWS) for lo, hi in rows]
    assert max(stages) - min(stages) <= 1


@pytest.mark.parametrize("S,ctas,per_sm", PLANS)
def test_decode_plan_fills_whole_waves(S, ctas, per_sm):
    """Whole waves where S is long enough; else as many splits of at
    least ``MIN_SPLIT_STAGES`` stages as S holds."""
    n_split, n_stages = DA._plan(S, ctas, H100_SMS, per_sm)
    slots = H100_SMS * per_sm
    whole = slots // math.gcd(slots, ctas)
    if n_split == whole:
        assert (ctas * n_split) % slots == 0
    else:
        assert n_split == max(1, n_stages // DA.MIN_SPLIT_STAGES) < whole
    assert n_split == 1 or n_stages // n_split >= DA.MIN_SPLIT_STAGES


def test_decode_plan_at_qwen2_7b_decode():
    """B = 8 CTAs per split: 33 splits give 264 CTAs, two full waves."""
    assert DA._plan(32768, 8, H100_SMS) == (33, 2048)
    assert DA.heads_per_cta(4, 128) == 4


@pytest.mark.parametrize("B", [8, 128])
def test_decode_plan_at_recurrentgemma_ring(B):
    """recurrentgemma-9b's 2,048-row ring (128 stages) on the CUDA-core
    kernel (D = 256, 16 query heads: two head chunks a kv head): splits of
    at least ``MIN_SPLIT_STAGES`` stages, where whole waves would deal
    66 (B 8) or 33 (B 128) splits of 2-4 stages."""
    ctas = B * 1 * 2
    n_split, n_stages = DA._plan(2048, ctas, H100_SMS, 8)
    assert n_stages == 128
    assert n_split == min({8: 66, 128: 33}[B], 128 // DA.MIN_SPLIT_STAGES)


@pytest.mark.parametrize("Hkv,D,want", [(4, 128, 4), (8, 128, 4), (1, 64, 1),
                                        (16, 64, 8), (2, 64, 2)])
def test_bulk_heads_per_cta(Hkv, D, want):
    hc = DA.heads_per_cta(Hkv, D)
    assert hc == want and Hkv % hc == 0
    assert DA.BULK_STAGES * 2 * DA.STAGE_ROWS * hc * D * 2 <= DA.BULK_SMEM


def test_split_rows_match_a_direct_deal():
    """Stage t goes to the split s with s * n / k <= t < (s + 1) * n / k."""
    n_split, n_stages, S = 7, 50, 50 * 16 - 5
    rows = DA.split_rows(n_split, n_stages, S)
    for t in range(n_stages):
        s = next(i for i in range(n_split)
                 if i * n_stages // n_split <= t < (i + 1) * n_stages // n_split)
        assert rows[s][0] <= t * DA.STAGE_ROWS < rows[s][1]


def test_library_hash_covers_the_shared_header():
    assert (compat.CSRC / "sm90.cuh").exists()
    for name in compat.SOURCES:
        assert compat.library_path(name).name.startswith(f"lib{name}-")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_module",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_111flash_wgmmaILi128ELb1ELb0ELb0EEEvNS_6ParamsE
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;       /* 0x00000a00ff017b82 */
                                                                /* 0x000fe20000000800 */
        /*0010*/              @!P0 UTMALDG.4D [UR8], [UR4] ;    /* 0x0000000000000000 */
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ; /* 0x00 */
        /*0030*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ; /* 0x00 */
\t\tFunction : _ZN12_GLOBAL__N_111decode_bulkILi128ELb0EEEvPK13__nv_bfloat16
        /*0000*/                   UBLKCP.S.G [UR4], [UR6], R2 ; /* 0x00 */
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ; /* 0x00 */
\t\tFunction : _ZN12_GLOBAL__N_114mlstm_wg_stateENS_8WgParamsE14CUtensorMap_stS1_S1_
        /*0000*/                   UTMALDG.4D [UR8], [UR4] ;    /* 0x0000000000000000 */
        /*0010*/                   HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24 ; /* 0x00 */
\t\tFunction : _ZN12_GLOBAL__N_115mlstm_wg_scoresENS_8WgParamsE14CUtensorMap_stS1_
        /*0000*/                   UTMALDG.4D [UR8], [UR4] ;    /* 0x0000000000000000 */
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ; /* 0x00 */
\t\tFunction : _ZN12_GLOBAL__N_112mlstm_wg_outENS_8WgParamsE14CUtensorMap_stS1_S1_S1_
        /*0000*/                   UTMALDG.4D [UR8], [UR4] ;    /* 0x0000000000000000 */
        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ; /* 0x00 */
\t\tFunction : _ZN12_GLOBAL__N_110rglru_ringIfEEv14CUtensorMap_stS1_PT_iii
        /*0000*/                   UTMALDG.4D [UR8], [UR4] ;    /* 0x0000000000000000 */
"""


def test_sass_counts_and_required_instructions(tmp_path, monkeypatch):
    cs = _chip_smoke()
    fake = tmp_path / "cuobjdump"
    fake.write_text(f"#!/bin/sh\ncat {tmp_path / 'sass.txt'}\n")
    fake.chmod(0o755)
    (tmp_path / "sass.txt").write_text(SASS)
    monkeypatch.setattr(cs, "cuobjdump", lambda: str(fake))
    counts = cs.sass_counts("lib.so")
    flash, decode, state, scores, out, ring = counts.values()
    assert flash == {"HGMMA": 2, "UTMALDG": 1, "UBLKCP": 0, "HMMA": 0}
    assert decode == {"HGMMA": 0, "UTMALDG": 0, "UBLKCP": 1, "HMMA": 1}
    assert state == scores == out == {"HGMMA": 1, "UTMALDG": 1, "UBLKCP": 0,
                                      "HMMA": 0}
    assert ring == {"HGMMA": 0, "UTMALDG": 1, "UBLKCP": 0, "HMMA": 0}
    names = list(counts)
    assert names[2:] == ["mlstm_wg_state", "mlstm_wg_scores", "mlstm_wg_out",
                         "rglru_ringIfE"]

    def libs(**broken):
        fns = dict(zip(names, counts.values()))
        for name, ops in broken.items():
            fns[name] = dict(fns[name], **ops)
        return {"flash_attention": {names[0]: fns[names[0]]},
                "decode_attention": {names[1]: fns[names[1]]},
                "mlstm_chunk": {n: fns[n] for n in names[2:5]},
                "rglru": {names[5]: fns[names[5]]}}

    cs.check_sass(libs())
    with pytest.raises(cs.CheckFailed, match="HGMMA"):
        cs.check_sass(libs(**{names[0]: {"HGMMA": 0}}))
    with pytest.raises(cs.CheckFailed, match="UBLKCP"):
        cs.check_sass(libs(**{names[1]: {"UBLKCP": 0}}))
    for name in names[2:5]:      # an mLSTM kernel on the CUDA cores
        with pytest.raises(cs.CheckFailed, match=f"{name} contains none of"):
            cs.check_sass(libs(**{name: {"HGMMA": 0}}))
    with pytest.raises(cs.CheckFailed, match="rglru_ringIfE"):
        cs.check_sass(libs(rglru_ringIfE={"UTMALDG": 0}))


@pytest.mark.parametrize("mangled,short", [
    ("_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_ddac23b611flash_wgmma"
     "ILi128ELb1ELb0ELb0EEEvNS_6ParamsE14CUtensorMap_stS2_",
     "flash_wgmmaILi128ELb1ELb0ELb0EE"),
    ("_ZN52_GLOBAL__N__14b1946f_19_decode_attention_cu_05af314f12decode_split"
     "I13__nv_bfloat16Li64EEEvPKT_", "decode_splitI13__nv_bfloat16Li64EE"),
    ("_ZN12_GLOBAL__N_111flash_wgmmaILi64ELb0ELb1ELb1EEEvNS_6ParamsE",
     "flash_wgmmaILi64ELb0ELb1ELb1EE"),
    ("_Z6kernelPf", "_Z6kernelPf"),
])
def test_sass_short_names(mangled, short):
    assert _chip_smoke().short_name(mangled) == short

