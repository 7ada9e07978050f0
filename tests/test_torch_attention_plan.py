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
    want = "bulk" if dtype == torch.bfloat16 and D in (64, 128, 256) else "simt"
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
    """recurrentgemma-9b's 2,048-row ring (128 stages) on the bulk kernel
    (D = 256, 16 query heads over one kv head: one CTA per batch row and
    split, one an SM, 132 slots).  Whole waves would take 33 splits of
    3-4 stages; the floor allows 8, and of those the fullest last wave is
    8 splits at B 8 (64 CTAs) and 1 at B 128 (128 of 132 slots: the kernel
    writes the output, no merge)."""
    assert DA.kernel_path(torch.bfloat16, 256) == "bulk"
    assert DA.heads_per_cta(1, 256) == 1
    per_sm = DA.bulk_ctas_per_sm(1, 256)
    assert per_sm == 1
    n_split, n_stages = DA._plan(2048, B, H100_SMS, per_sm, fullest=True)
    assert n_stages == 128 and 128 // DA.MIN_SPLIT_STAGES == 8
    assert n_split == {8: 8, 128: 1}[B]


# (S, CTAs per split, CTAs per SM) where the floor caps the split count
# below whole waves: the ring at B 128 and B 8, qwen2-7b at B 1, a ragged
# S, and the CUDA-core kernel's stablelm-3b decode (256 CTAs a split).
CAPPED = [(2048, 128, 2), (2048, 8, 2), (32768, 1, 1), (4000, 8, 1),
          (8192, 256, 8), (2048, 128, 3)]


@pytest.mark.parametrize("S,ctas,per_sm", CAPPED)
def test_decode_plan_fullest_last_wave(S, ctas, per_sm):
    """With ``fullest`` (the bulk kernel) a capped plan takes the count of
    at most ``cap`` splits whose last wave is fullest, the fewest of those;
    without it (the CUDA-core kernel) the cap itself.  Either way whole
    waves win where the cap allows them (qwen2-7b: 33)."""
    slots = H100_SMS * per_sm
    n_stages = -(-S // DA.STAGE_ROWS)
    cap = max(1, n_stages // DA.MIN_SPLIT_STAGES)
    assert slots // math.gcd(slots, ctas) > cap

    def fill(n):
        return ctas * n / (slots * -(-ctas * n // slots))

    n_split, _ = DA._plan(S, ctas, H100_SMS, per_sm, fullest=True)
    assert 1 <= n_split <= cap
    assert all(fill(n) < fill(n_split) or (fill(n) == fill(n_split) and n >= n_split)
               for n in range(1, cap + 1))
    assert DA._plan(S, ctas, H100_SMS, per_sm) == (cap, n_stages)
    assert DA._plan(32768, 8, H100_SMS, 1, fullest=True) == (33, 2048)


@pytest.mark.parametrize("Hkv,D,want", [(4, 128, 4), (8, 128, 4), (1, 64, 1),
                                        (16, 64, 8), (2, 64, 2), (1, 256, 1),
                                        (2, 256, 1)])
def test_bulk_heads_per_cta(Hkv, D, want):
    hc = DA.heads_per_cta(Hkv, D)
    assert hc == want and Hkv % hc == 0 and hc <= DA.BULK_MAX_HEADS[D]
    assert DA.bulk_smem(hc, D) <= DA.BULK_SMEM


@pytest.mark.parametrize("Hkv,D,smem,per_sm", [(4, 128, 131_136, 1),
                                               (1, 256, 135_296, 1),
                                               (2, 256, 135_296, 1),
                                               (1, 64, 16_448, 13)])
def test_bulk_ctas_per_sm_follow_from_shared_memory(Hkv, D, smem, per_sm):
    """A bulk CTA's shared memory is its ring of stages of 16 K and 16 V
    rows (4 stages; at D = 256 8 stages of 528-byte rows) and a full and an
    empty barrier of 8 bytes a stage; an SM's 228 KiB, less 1 KiB for
    each CTA, holds as many as fit: one at recurrentgemma-9b's ring and at
    qwen2-7b, 13 of a lone kv head of 64."""
    hc = DA.heads_per_cta(Hkv, D)
    stage = 16 * (hc * D * 2 + (16 if D == 256 else 0))
    stages = 8 if D == 256 else 4
    assert DA.BULK_STAGES[D] == stages
    assert DA.bulk_smem(hc, D) == stages * (2 * stage + 16) == smem
    assert DA.bulk_ctas_per_sm(Hkv, D) == per_sm \
        == 228 * 1024 // (smem + DA.CTA_RESERVED_SMEM)


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
\t\tFunction : _ZN12_GLOBAL__N_111flash_wgmmaILi80ELb1ELb0ELb0EEEvNS_6ParamsE
        /*0000*/                   UTMALDG.4D [UR8], [UR4] ;    /* 0x0000000000000000 */
        /*0010*/                   HGMMA.64x16x16.F32.BF16 R24, R4, gdesc[UR4], R24 ; /* 0x00 */
\t\tFunction : _ZN12_GLOBAL__N_111flash_wgmmaILi80ELb0ELb0ELb0EEEvNS_6ParamsE
        /*0000*/                   UTMALDG.4D [UR8], [UR4] ;    /* 0x0000000000000000 */
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, R4, gdesc[UR4], R24 ; /* 0x00 */
\t\tFunction : _ZN12_GLOBAL__N_111flash_wgmmaILi256ELb1ELb1ELb0EEEvNS_6ParamsE
        /*0000*/                   UTMALDG.5D [UR8], [UR4] ;    /* 0x0000000000000000 */
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R184, gdesc[UR4], RZ, !UPT, gsb0 ; /* 0x00 */
        /*0020*/                   HGMMA.64x256x16.F32.BF16 R24, R152, gdesc[UR8].tnspB, R24, gsb0 ; /* 0x00 */
\t\tFunction : _ZN12_GLOBAL__N_111decode_bulkILi128ELb0EEEvPK13__nv_bfloat16
        /*0000*/                   UBLKCP.S.G [UR4], [UR6], R2 ; /* 0x00 */
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ; /* 0x00 */
\t\tFunction : _ZN12_GLOBAL__N_111decode_bulkILi256ELb0EEEvPK13__nv_bfloat16
        /*0000*/                   LDGSTS.E.BYPASS.LTC128B.128 [R3], [R4.64] ; /* 0x00 */
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
    flash, flash80, flash80nc, flash256, decode, decode256, state, scores, \
        out, ring = counts.values()
    assert flash == flash256 == {"HGMMA": 2, "UTMALDG": 1, "UBLKCP": 0,
                                 "HMMA": 0, "LDGSTS": 0}
    assert flash80 == flash80nc == {"HGMMA": 1, "UTMALDG": 1, "UBLKCP": 0,
                                    "HMMA": 0, "LDGSTS": 0}
    assert decode == {"HGMMA": 0, "UTMALDG": 0, "UBLKCP": 1, "HMMA": 1,
                      "LDGSTS": 0}
    assert decode256 == {"HGMMA": 0, "UTMALDG": 0, "UBLKCP": 0, "HMMA": 1,
                         "LDGSTS": 1}
    assert state == scores == out == {"HGMMA": 1, "UTMALDG": 1, "UBLKCP": 0,
                                      "HMMA": 0, "LDGSTS": 0}
    assert ring == {"HGMMA": 0, "UTMALDG": 1, "UBLKCP": 0, "HMMA": 0,
                    "LDGSTS": 0}
    names = list(counts)
    assert names[1:6] == ["flash_wgmmaILi80ELb1ELb0ELb0EE",
                          "flash_wgmmaILi80ELb0ELb0ELb0EE",
                          "flash_wgmmaILi256ELb1ELb1ELb0EE",
                          "decode_bulkILi128ELb0EE", "decode_bulkILi256ELb0EE"]
    assert names[6:] == ["mlstm_wg_state", "mlstm_wg_scores", "mlstm_wg_out",
                         "rglru_ringIfE"]

    def libs(**broken):
        fns = dict(zip(names, counts.values()))
        for name, ops in broken.items():
            fns[name] = dict(fns[name], **ops)
        return {"flash_attention": {n: fns[n] for n in names[0:4]},
                "decode_attention": {n: fns[n] for n in names[4:6]},
                "mlstm_chunk": {n: fns[n] for n in names[6:9]},
                "rglru": {names[9]: fns[names[9]]}}

    cs.check_sass(libs())
    with pytest.raises(cs.CheckFailed, match="HGMMA"):
        cs.check_sass(libs(**{names[0]: {"HGMMA": 0}}))
    for name in names[1:4]:      # the D = 80 or 256 instance off the tensor cores
        with pytest.raises(cs.CheckFailed, match=f"{name[:-1]} contains none of"):
            cs.check_sass(libs(**{name: {"HGMMA": 0}}))
        with pytest.raises(cs.CheckFailed, match="UTMALDG"):
            cs.check_sass(libs(**{name: {"UTMALDG": 0}}))
    with pytest.raises(cs.CheckFailed, match="flash_wgmmaILi256ELb1ELb1ELb0E not found"):
        cs.check_sass({**libs(), "flash_attention": {n: counts[n] for n in names[0:3]}})
    with pytest.raises(cs.CheckFailed, match="UBLKCP"):
        cs.check_sass(libs(**{names[4]: {"UBLKCP": 0}}))
    with pytest.raises(cs.CheckFailed, match="decode_bulkILi256ELb0E contains "
                       "none of .'LDGSTS'"):
        cs.check_sass(libs(**{names[5]: {"LDGSTS": 0}}))
    with pytest.raises(cs.CheckFailed, match="decode_bulkILi256ELb0E contains "
                       "none of .'HMMA'"):   # D = 256 back on the CUDA cores
        cs.check_sass(libs(**{names[5]: {"HMMA": 0}}))
    for name in names[6:9]:      # an mLSTM kernel on the CUDA cores
        with pytest.raises(cs.CheckFailed, match=f"{name} contains none of"):
            cs.check_sass(libs(**{name: {"HGMMA": 0}}))
    with pytest.raises(cs.CheckFailed, match="rglru_ringIfE"):
        cs.check_sass(libs(rglru_ringIfE={"UTMALDG": 0}))


PTXAS_LOG = """\
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_ZN12_GLOBAL__N_111flash_wgmmaILi256ELb1ELb1ELb0EEEvNS_6ParamsE'
ptxas info    : 0 bytes gmem
ptxas info    : Function properties for _ZN12_GLOBAL__N_16cappedEff
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111decode_bulkILi256ELb1EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111decode_bulkILi256ELb1EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111decode_bulkILi128ELb0EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111decode_bulkILi128ELb0EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111flash_wgmmaILi80ELb0ELb1ELb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111flash_wgmmaILi80ELb0ELb1ELb1EEEvNS_6ParamsE
    24 bytes stack frame, 20 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 912 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111flash_wgmmaILi256ELb1ELb1ELb0EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111flash_wgmmaILi256ELb1ELb1ELb0EEEvNS_6ParamsE
    216 bytes stack frame, 228 bytes spill stores, 228 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 912 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111flash_wgmmaILi256ELb0ELb0ELb0EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111flash_wgmmaILi256ELb0ELb0ELb0EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 240 registers, used 3 barriers, 912 bytes cmem[0]
"""


def test_ptxas_report_names_the_new_instances():
    """The build phase's registers and spills of ``PTXAS_REPORTED``, by
    kernel: another kernel's numbers and a device function's properties
    block are not taken for theirs."""
    report = _chip_smoke().ptxas_report(PTXAS_LOG)
    assert report == {
        "decode_bulkILi256ELb1EE": {"spill_stores": 0, "spill_loads": 0,
                                    "registers": 118, "notes": []},
        "flash_wgmmaILi80ELb0ELb1ELb1EE": {"spill_stores": 20,
                                           "spill_loads": 16,
                                           "registers": 168, "notes": []},
        "flash_wgmmaILi256ELb1ELb1ELb0EE": {"spill_stores": 228,
                                            "spill_loads": 228,
                                            "registers": 168,
                                            "notes": ["C7512"]},
        "flash_wgmmaILi256ELb0ELb0ELb0EE": {"spill_stores": 0,
                                            "spill_loads": 0,
                                            "registers": 240, "notes": []}}


def test_build_phase_requires_clean_d256_instances():
    """The build phase fails unless all eight ``flash_wgmma<256, ...>``
    instances are reported, none spills and ptxas notes none (C7512: its
    wgmmas serialized)."""
    cs = _chip_smoke()
    clean = {"spill_stores": 0, "spill_loads": 0, "registers": 240, "notes": []}
    report = {f"flash_wgmmaILi256ELb{c}ELb{w}ELb{k}EE": dict(clean)
              for c in (0, 1) for w in (0, 1) for k in (0, 1)}
    report["flash_wgmmaILi80ELb0ELb1ELb1EE"] = dict(clean, spill_stores=20)
    cs.check_ptxas(report)
    name = "flash_wgmmaILi256ELb1ELb1ELb0EE"
    with pytest.raises(cs.CheckFailed, match=f"{name} spills 4 B"):
        cs.check_ptxas({**report, name: dict(clean, spill_stores=4)})
    with pytest.raises(cs.CheckFailed, match=f"{name} spills 0 B .stores., 8 B"):
        cs.check_ptxas({**report, name: dict(clean, spill_loads=8)})
    with pytest.raises(cs.CheckFailed, match=f"notes .'C7512'. on {name}"):
        cs.check_ptxas({**report, name: dict(clean, notes=["C7512"])})
    del report[name]
    with pytest.raises(cs.CheckFailed, match="ptxas report of flash_wgmmaILi256E"):
        cs.check_ptxas(report)


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

