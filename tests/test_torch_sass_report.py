"""The SASS and ptxas parsers that chip_smoke.py reads K5's and K10's
substep loops, K8/K9's horizon loops and reset blocks, and the kernels'
registers with (reinmav_tpu_torch/sass_report.py,
reinmav_tpu_torch/_build.py::ptxas_report), on hand-written text in the
formats of cuobjdump -sass and ptxas -v.  Exact counts: no tolerance."""

from reinmav_tpu_torch import _build, sass_report

SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_120hover_rollout_kernelEPKfPfS2_xiiS1_S1_ffPKv
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;         /* 0x00000a00ff017b82 */
                                                                  /* 0x000fe20000000800 */
.L_x_0:
        /*0010*/                   FFMA R2, R3, R4, R5 ;          /* 0x0000000403027223 */
        /*0020*/                   MUFU.RCP R6, R2 ;              /* 0x0000000200067308 */
.L_x_1:
        /*0030*/                   FADD R7, R6, R2 ;              /* 0x0000000206077221 */
        /*0040*/              @!P0 BRA `(.L_x_1) ;                /* 0xfffffffc00f88947 */
        /*0050*/                   F2I.TRUNC R8, R7 ;             /* 0x0000000700087305 */
        /*0060*/                   BSSY B0, `(.L_x_2) ;           /* 0x0000002000007945 */
        /*0070*/                   FMUL R9, R8, R2 ;              /* 0x0000000208097220 */
.L_x_2:
        /*0080*/                   BSYNC B0 ;                     /* 0x0000000000007941 */
        /*0090*/               @P1 BRA `(.L_x_0) ;                /* 0xfffffff400dc1947 */
        /*00a0*/                   STG.E [R10.64], R9 ;           /* 0x000000090a007986 */
        /*00b0*/                   EXIT ;                         /* 0x000000000000794d */
"""


def test_substep_loop_counts_by_pipe():
    """Two loops, one nested in the other: the outer holds the MUFU, so it
    is the substep loop, and its count leaves the inner loop out."""
    funcs = sass_report.parse_functions(SASS)
    (name, insns), = funcs.items()
    assert "hover_rollout_kernel" in name and len(insns) == 12
    assert insns[4][:2] == (0x40, "BRA") and insns[4][2].strip() == "0x30"
    rows = sorted(sass_report.loops(insns), key=lambda r: r["start"])
    assert [(r["start"], r["end"]) for r in rows] == [(0x10, 0x90), (0x30, 0x40)]
    outer, inner = rows
    assert inner["n"] == 2 and inner["mufu_ops"] == []
    assert outer["inner"] == [(0x30, 0x40)]
    # FFMA, FMUL | MUFU.RCP, F2I.TRUNC | BSSY, BSYNC, BRA
    assert (outer["n"], outer["fp32/int"], outer["mufu"], outer["other"]) == (7, 2, 2, 3)
    assert sass_report.substep_loop(rows) is outer
    assert [sass_report.opcode_class(op) for op in ("FFMA", "MUFU.EX2", "I2F.U32", "LDG.E",
                                                    "SHFL.BFLY", "UIADD3", "IMAD.WIDE")] == \
        ["fp32/int", "mufu", "mufu", "other", "other", "other", "fp32/int"]


def test_ptxas_report_lines(tmp_path):
    """Registers, spills and the rest of ptxas's line, one line a kernel, by
    its name without the anonymous namespace."""
    log = tmp_path / "lib.ptxas.txt"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122reinmav_rollout_kernelEPKfPfPhxi"
        "NS_13ReinmavParamsE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_122reinmav_rollout_kernelEPKfPf\n"
        "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 48 registers, used 0 barriers, 32 bytes cumulative stack size\n"
        "ptxas info    : Compiling entry function '_Z12plain_kernelPf' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n")
    lines = _build.ptxas_report(log)
    assert len(lines) == 2
    assert lines[0].startswith("ptxas: reinmav_rollout_kernel: ")
    assert lines[0].endswith(": 48 registers, spill stores 0 B, loads 0 B, used 0 barriers, "
                             "32 bytes cumulative stack size")
    assert lines[1].endswith(": 255 registers, spill stores 8 B, loads 12 B, used 1 barriers")


CLOSED_LOOP = """
\t\tFunction : _ZN12_GLOBAL__N_118closed_loop_kernelINS_10Quad2dLoopELb0EEEvPKfPfS4_PixjjiNT_6ParamsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   FFMA R2, R3, R4, R5 ;
        /*0020*/                   MUFU.SIN R6, R2 ;
        /*0030*/                   VOTE.ANY R7, PT, P0 ;
.L_x_1:
        /*0040*/                   IMAD.WIDE.U32 R8, R9, -0x2daee0ad, RZ ;
        /*0050*/                   LOP3.LUT R10, R11, R12, R13, 0x96, !PT ;
        /*0060*/                   IMAD.HI.U32 R14, R15, 0xcd9e8d57, RZ ;
        /*0070*/                   SHFL.IDX PT, R16, R17, R18, 0x1f ;
        /*0080*/               @P1 BRA `(.L_x_1) ;
        /*0090*/               @P2 BRA `(.L_x_0) ;
        /*00a0*/                   EXIT ;
"""


def test_closed_loop_kernel_name_horizon_loop_and_reset_block():
    """A template instance's demangled name, shortened; its horizon loop
    (the one with the MUFU) without the nested reset loop; the reset block
    spans the Philox multiplies, by either spelling of their immediates, in
    the nested loop or, with no nested loop, in the horizon loop's count."""
    (mangled, insns), = sass_report.parse_functions(CLOSED_LOOP).items()
    pretty, = sass_report.demangle([mangled])
    assert sass_report.short_name(pretty) == "closed_loop_kernel<Quad2dLoop, false>"
    assert any(k in sass_report.short_name(pretty) for k in sass_report.KERNELS)
    rows = sass_report.loops(insns)
    horizon = sass_report.substep_loop(rows)
    assert (horizon["start"], horizon["end"], horizon["inner"]) == (0x10, 0x90, [(0x40, 0x80)])
    # FFMA | MUFU.SIN | VOTE, BRA
    assert (horizon["n"], horizon["fp32/int"], horizon["mufu"], horizon["other"]) == (4, 1, 1, 2)
    assert sass_report.reset_span(insns, horizon) == {
        "start": 0x40, "end": 0x60, "n": 3, "fp32/int": 3, "mufu": 0, "other": 0, "in_loop": 0}
    flat = CLOSED_LOOP.replace("@P1 BRA `(.L_x_1)", "NOP")
    (_, insns), = sass_report.parse_functions(flat).items()
    horizon = sass_report.substep_loop(sass_report.loops(insns))
    assert horizon["n"] == 9 and sass_report.reset_span(insns, horizon)["in_loop"] == 3
    no_reset = CLOSED_LOOP.replace("-0x2daee0ad", "R20").replace("0xcd9e8d57", "R21")
    (_, insns), = sass_report.parse_functions(no_reset).items()
    assert sass_report.reset_span(insns, sass_report.substep_loop(
        sass_report.loops(insns))) is None


def test_compare_two_libraries(monkeypatch, tmp_path):
    """--against: a kernel with the same instructions is ``same``, one whose
    instructions differ ``differ``, one in one library only is listed so;
    kernels match by demangled name, whatever prefix their build gave the
    anonymous namespace."""
    other = CLOSED_LOOP.replace("FFMA R2, R3, R4, R5", "FMUL R2, R3, R4")
    rebuilt = CLOSED_LOOP.replace("_GLOBAL__N_1", "_GLOBAL__N_2")
    assert rebuilt != CLOSED_LOOP
    texts = {tmp_path / "a.so": SASS + CLOSED_LOOP, tmp_path / "b.so": SASS + other,
             tmp_path / "c.so": rebuilt}
    monkeypatch.setattr(sass_report, "_disassemble", lambda lib: texts[lib])
    got = sass_report.compare(tmp_path / "a.so", tmp_path / "b.so")
    assert got == {"same": ["hover_rollout_kernel"],
                   "differ": ["closed_loop_kernel<Quad2dLoop, false>"],
                   "only_lib": [], "only_other": []}
    got = sass_report.compare(tmp_path / "a.so", tmp_path / "c.so")
    assert got["same"] == ["closed_loop_kernel<Quad2dLoop, false>"]
    assert got["only_lib"] == ["hover_rollout_kernel"]


K1_LOOP = """
\t\tFunction : _ZN12_GLOBAL__N_118closed_loop_kernelINS_10Quad3dLoopILb1EEELb0EEEvPKfPfS5_PixjjiNT_6ParamsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   FFMA R2, R3, R4, R5 ;
        /*0020*/                   MUFU.RSQ R6, R2 ;
        /*0030*/              @!P0 BRA `(.L_x_1) ;
        /*0040*/                   IMAD.HI.U32 R8, R9, -0x2daee0ad, RZ ;
        /*0050*/                   LOP3.LUT R10, R11, R12, R13, 0x96, !PT ;
        /*0060*/                   IMAD.WIDE.U32 R14, R15, 0xcd9e8d57, RZ ;
.L_x_1:
        /*0070*/                   FADD R16, R6, R2 ;
        /*0080*/               @P2 BRA `(.L_x_0) ;
        /*0090*/                   EXIT ;
"""


def test_k1_horizon_loop_and_reset_block():
    """K1's kernel (the closed-loop template's Quad3dLoop instance) is one of
    the reported families; its horizon loop holds the reset block inline
    (no nested loop), counted apart."""
    (mangled, insns), = sass_report.parse_functions(K1_LOOP).items()
    short = sass_report.short_name(sass_report.demangle([mangled])[0])
    assert short == "closed_loop_kernel<Quad3dLoop<true>, false>"
    assert any(k in short for k in sass_report.KERNELS)
    horizon = sass_report.substep_loop(sass_report.loops(insns))
    assert (horizon["start"], horizon["end"], horizon["n"]) == (0x10, 0x80, 8)
    assert sass_report.horizon_loop(sass_report.loops(insns)) == horizon
    assert sass_report.reset_span(insns, horizon) == {
        "start": 0x40, "end": 0x60, "n": 3, "fp32/int": 3, "mufu": 0, "other": 0, "in_loop": 3}


#: A K2/K6 source reduced to its markers (the line numbers are what counts).
PPO_SRC = """\
// 1
    for (int t = 0; t < horizon; ++t) {
      x[d] = s[d];                                   // 3 other
      // The actor-critic, one tower at a time.
      for (int tw = 0; tw < 2; ++tw) {
        z += w1t[tw][k][d] * x[d];                   // 6 mlp
        h1[k] = tanhf(z);                            // 7 tanhf
        for (int j = 0; j < kH; ++j) z += v.x * h1[4 * q];  // 8 mlp
      }
      // Gaussian action; logp from the rounded action.
      const uint4 ub = reinmav::philox4x32_10(c, seed, 0u);  // 11 noise
      // Env step.
      const float raw = Env::step(s, act, p, env_consts, done);  // 13 env step
      if (done) Env::reset(s, env, t, seed, 2u, p);  // 14 reset
    }
    o.returns[i] = ret;                              // 16 other
"""

HEADER = """\
#pragma once
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
  return c;
}
template <int D>
__device__ __forceinline__ void reset_uniform(float (&s)[D], uint32_t env) {
  s[0] = 1.0f;
}
__device__ __forceinline__ float quad3d_dynamics(float (&s)[10]) {
  return s[0];
}
"""

#: nvdisasm -g -gi text of one K2 instance: a tower loop (0x20-0xe0) that
#: holds a unit loop (0x40-0xa0: 64 FFMAs and one tanhf's MUFU.EX2, one
#: unit a pass), the horizon loop 0x10-0x180, and a slow path loop.
PPO_LINEINFO = """
\t.section\t.text._ZN12_GLOBAL__N_118ppo_rollout_kernelIN7reinmav9Quad3dEnvELb1ELb1EEEvPKfS4_S4_S4_xijNT_6ParamsENS_10RolloutOutE,"ax",@progbits
_ZN12_GLOBAL__N_118ppo_rollout_kernelIN7reinmav9Quad3dEnvELb1ELb1EEEvPKfS4_S4_S4_xijNT_6ParamsENS_10RolloutOutE:
        //## File "/src/ppo_rollout.cu", line 1
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
        //## File "/src/ppo_rollout.cu", line 3
        /*0010*/                   FADD R2, R3, R4 ;
.L_x_1:
        //## File "/src/ppo_rollout.cu", line 6
        /*0020*/                   FFMA R2, R3, R4, R5 ;
        //## File "/src/ppo_rollout.cu", line 7
        /*0030*/                   MUFU.EX2 R6, R2 ;
.L_x_2:
        //## File "/src/ppo_rollout.cu", line 8
        /*0040*/                   LDS.128 R8, [R9] ;
""" + "".join(f"        /*{0x41 + k:04x}*/                   FFMA R2, R8, R4, R2 ;\n"
              for k in range(64)) + """\
        //## File "/src/ppo_rollout.cu", line 7
        /*0090*/                   MUFU.EX2 R6, R2 ;
        //## File "/src/ppo_rollout.cu", line 8
        /*00a0*/               @P0 BRA `(.L_x_2) ;
        /*00e0*/               @P1 BRA `(.L_x_1) ;
        //## File "/src/quad3d_common.cuh", line 3 inlined at "/src/ppo_rollout.cu", line 11
        /*00f0*/                   IMAD.HI.U32 R8, R9, -0x2daee0ad, RZ ;
.L_x_3:
        //## File "/cuda/include/crt/math_functions.hpp", line 900 inlined at "/src/ppo_rollout.cu", line 11
        /*0100*/                   LDG.E.CONSTANT R10, [R12.64] ;
        /*0110*/               @P2 BRA `(.L_x_3) ;
        //## File "/src/quad3d_common.cuh", line 10 inlined at "/src/env_kinds.cuh", line 40 inlined at "/src/ppo_rollout.cu", line 13
        /*0120*/                   FMUL R2, R3, R4 ;
        //## File "/src/quad3d_common.cuh", line 3 inlined at "/src/quad3d_common.cuh", line 7 inlined at "/src/ppo_rollout.cu", line 14
        /*0130*/                   IMAD.WIDE.U32 R14, R15, 0xcd9e8d57, RZ ;
        //## File "/src/ppo_rollout.cu", line 2
        /*0180*/               @P3 BRA `(.L_x_0) ;
        //## File "/src/ppo_rollout.cu", line 16
        /*0190*/                   EXIT ;
"""


def test_lineinfo_blocks_and_levels():
    """nvdisasm's line table: each instruction of K2/K6's horizon loop goes
    to the block of its outermost frame in the kernel's file; the tower
    loop holds the unit loop; the unit loop's 64 FFMAs make one unit a
    pass, so 64 passes a tower; a loop of the toolkit's slow path is
    counted apart."""
    (name, insns), = sass_report.parse_lineinfo(PPO_LINEINFO).items()
    assert name.startswith("_ZN12_GLOBAL__N_118ppo_rollout_kernel")
    assert insns[0][3] == [("/src/ppo_rollout.cu", 1)]
    assert insns[-3][3] == [("/src/quad3d_common.cuh", 3), ("/src/quad3d_common.cuh", 7),
                            ("/src/ppo_rollout.cu", 14)]
    got = sass_report.block_counts(insns, "ppo_rollout.cu", PPO_SRC,
                                   {"quad3d_common.cuh": HEADER})
    c = got["counts"]
    assert c["other"] == {"horizon": 2, "tower": 0, "unit": 0, "slow": 0}
    assert c["mlp"] == {"horizon": 0, "tower": 2, "unit": 66, "slow": 0}
    assert c["tanhf"] == {"horizon": 0, "tower": 1, "unit": 1, "slow": 0}
    assert c["noise"] == {"horizon": 1, "tower": 0, "unit": 0, "slow": 2}
    assert c["env step"]["horizon"] == 1 and c["reset"]["horizon"] == 1
    assert got["units"] == 1 and got["unattributed"] == 0
    assert got["per_env_step"]["mlp"] == 2 * 2 + 2 * 64 * 66
    assert got["per_env_step"]["tanhf"] == 2 + 128


def test_lineinfo_without_inline_frames():
    """``nvdisasm -g`` alone: a header's draw code before the first env-step
    instruction is the noise, after it the reset."""
    text = "\n".join(line.split(" inlined at ")[0] for line in PPO_LINEINFO.splitlines())
    (_, insns), = sass_report.parse_lineinfo(text).items()
    got = sass_report.block_counts(insns, "ppo_rollout.cu", PPO_SRC,
                                   {"quad3d_common.cuh": HEADER})
    assert got["counts"]["noise"]["horizon"] == 1 and got["counts"]["reset"]["horizon"] == 1
    assert got["counts"]["env step"]["horizon"] == 1
    assert got["unattributed"] == 2  # the toolkit header's slow path
    assert sass_report.header_functions(HEADER)[3] == "philox4x32_10"
    assert sass_report.header_functions(HEADER)[7] == "reset_uniform"


def test_env_step_count_weighs_the_loop_levels():
    """K2/K6's instructions an env-step without a lineinfo build: the
    horizon loop's own body once, the tower loop's twice, the unit loop's
    2 * 64 / units times, the slow path's never."""
    (_, insns), = sass_report.parse_lineinfo(PPO_LINEINFO).items()
    plain = [(a, op, args) for a, op, args, _ in insns]
    one = sass_report.env_step_count(plain)
    assert one["units"] == 1 and one["static"] == 5 + 2 + 3 + 67
    assert one["per_env_step"] == 5 + 2 * 3 + 128 * 67
    assert one["mufu"] == 2 * 1 + 128 * 1
    # Four tanhf a pass (four MUFU.EX2 in the unit loop): 16 passes a tower.
    four = PPO_LINEINFO.replace("/*0090*/                   MUFU.EX2 R6, R2 ;",
                                "/*0090*/                   MUFU.EX2 R6, R2 ;\n" + "".join(
                                    f"        /*{0x91 + k:04x}*/                   MUFU.EX2 R6, "
                                    f"R2 ;\n" for k in range(3)))
    (_, insns), = sass_report.parse_lineinfo(four).items()
    got = sass_report.env_step_count([(a, op, args) for a, op, args, _ in insns])
    assert got["units"] == 4 and got["per_env_step"] == 5 + 2 * 3 + 32 * 70


K7_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_124offpolicy_collect_kernelIN7reinmav8HoverEnvELi0EEEvPKfxiNS_5ActorES4_jNT_6ParamsEPfS9_
        /*0000*/                   LDGSTS.E [R1], desc[UR4][R2.64] ;
.L_x_0:
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0020*/                   STS [R5], R2 ;
        /*0030*/               @P0 BRA `(.L_x_0) ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
.L_x_4:
        /*0050*/                   LDS R20, [R21] ;
        /*0060*/                   LDS R22, [R23] ;
        /*0070*/                   FFMA R24, R20, R22, R24 ;
        /*0080*/               @P4 BRA `(.L_x_4) ;
.L_x_1:
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
.L_x_2:
        /*00a0*/                   LDG.E R6, desc[UR4][R8.64] ;
        /*00b0*/                   LDG.E R7, desc[UR4][R8.64+0x80] ;
        /*00c0*/                   STS [R9], R6 ;
        /*00d0*/                   LDG.E R6, desc[UR4][R8.64+0x100] ;
        /*00e0*/                   STS [R9+0x80], R7 ;
        /*00f0*/               @P1 BRA `(.L_x_2) ;
        /*0100*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
.L_x_3:
        /*0110*/                   LDS.128 R12, [R10] ;
        /*0120*/                   LDS.U.128 R16, [R11] ;
        /*0130*/                   FFMA R30, R12, R16, R30 ;
        /*0140*/                   FFMA R31, R13, R16, R31 ;
        /*0150*/                   FFMA R32, R14, R16, R32 ;
        /*0160*/                   FFMA R33, R15, R16, R33 ;
        /*0170*/               @P2 BRA `(.L_x_3) ;
        /*0180*/                   FFMA R40, R30, R41, R40 ;
        /*0190*/                   SHFL.BFLY PT, R42, R40, 0x4, 0x1f ;
        /*01a0*/               @P3 BRA `(.L_x_1) ;
        /*01b0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*01c0*/                   IMAD.WIDE.U32 R50, R51, -0x2daee0ad, RZ ;
        /*01d0*/                   LOP3.LUT R52, R53, R54, R55, 0x96, !PT ;
        /*01e0*/                   IMAD.HI.U32 R56, R57, 0xcd9e8d57, RZ ;
        /*01f0*/                   MUFU.EX2 R58, R59 ;
        /*0200*/                   STG.E desc[UR4][R60.64], R58 ;
        /*0210*/                   EXIT ;
"""


def test_k7_phases_w2_loop_copies_and_phase4():
    """K7's report: the W2 loop is the innermost FFMA loop with LDS.128
    (both spellings), not the chunk loop around it, which holds FFMA and
    shuffles of the fold; the chunk copy nested in that loop counts its
    LDG before the first STS and is told apart from the staging copy; the
    first layer is the other innermost FFMA loop; phase 4 is what follows
    the last barrier, with its Philox span counted apart."""
    (mangled, insns), = sass_report.parse_functions(K7_SASS).items()
    short = sass_report.short_name(sass_report.demangle([mangled])[0])
    assert any(k in short for k in sass_report.KERNELS)
    k7 = sass_report.k7_counts(insns)
    mlp = k7["mlp"]
    assert (mlp["start"], mlp["end"], mlp["n"]) == (0x110, 0x170, 7)
    assert (mlp["FFMA"], mlp["LDS.128"], mlp["LDS"], mlp["ffma_per_lds128"]) == (4, 2, 0, 2.0)
    staging, chunk = k7["copy"]
    assert (staging["start"], staging["ldg_before_sts"], staging["in_w2"]) == (0x10, 1, False)
    assert (chunk["start"], chunk["end"], chunk["LDG"], chunk["STS"]) == (0xa0, 0xf0, 3, 2)
    assert (chunk["ldg_before_sts"], chunk["in_w2"]) == (2, True)
    assert k7["ldgsts"] == 1
    p2 = k7["phase2"]
    assert (p2["start"], p2["FFMA"], p2["LDS"], p2["lds_per_ffma"]) == (0x50, 1, 2, 2.0)
    p4 = k7["phase4"]
    assert (p4["n"], p4["fp32/int"], p4["mufu"], p4["other"]) == (6, 3, 1, 2)
    assert p4["philox"] == [{"start": 0x1c0, "end": 0x1e0, "n": 3, "multiplies": 2}]
    assert p4["without_philox"] == 3
    line = sass_report.k7_line(k7)
    assert "2 FFMA an LDS.128" in line and "W2 chunk copy loop" in line
    assert "2 LDG before its first STS" in line and "cp.async (LDGSTS) 1" in line


def test_philox_clusters_split_on_a_gap():
    """Two Philox blocks far apart are two spans; multiplies closer than
    the gap are one."""
    mul = (0, "IMAD.HI.U32", "R1, R2, 0xd2511f53, RZ")
    other = (0, "FADD", "R3, R4, R5")
    seq = [mul, other, mul] + [other] * 50 + [mul]
    insns = [(16 * i, op, args) for i, (_, op, args) in enumerate(seq)]
    spans = sass_report.philox_clusters(insns)
    assert [(s["n"], s["multiplies"]) for s in spans] == [(3, 2), (1, 1)]


K3K4 = """
\t\tFunction : _ZN12_GLOBAL__N_115ppo_loss_kernelILi10ELi4ELb0ELb1EEEvPKfxPKixiS2_S2_N7reinmav8ppo_loss7LossCfgEPf
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   LDSM.16.MT88.4 R8, [R3] ;
        /*0020*/                   HMMA.16816.F32.BF16 R12, R4, R8, R12 ;
        /*0030*/                   HMMA.16816.F32.BF16 R16, R4, R10, R16 ;
        /*0040*/                   MUFU.EX2 R20, R21 ;
        /*0050*/                   FFMA R22, R23, R24, R25 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_115ppo_loss_kernelILi10ELi4ELb0ELb0EEEvPKfxPKixiS2_S2_N7reinmav8ppo_loss7LossCfgEPf
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   FFMA R6, R7, R8, R6 ;
        /*0020*/                   FFMA R9, R7, R10, R9 ;
        /*0030*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_117ppo_update_kernelILi10ELi4ELb0ELb0EEEvNS_10UpdateArgsE
        /*0000*/                   FFMA R6, R7, R8, R6 ;
        /*0010*/                   EXIT ;
"""


def test_k3k4_product_counts_and_the_float32_instances_against_a_parent(monkeypatch, tmp_path,
                                                                         capsys):
    """K3/K4's instances: HMMA (the bf16 ones apart), FFMA, LDSM, MUFU and
    BAR counted by report(); with --against, the float32 instances that
    are the other library's instruction for instruction, the ones that
    differ, and the bf16 instances left out of that list."""
    parent = K3K4.replace("HMMA.16816.F32.BF16 R16, R4, R10, R16", "FFMA R16, R4, R10, R16")
    parent = parent.replace("FFMA R9, R7, R10, R9", "FFMA R9, R7, R11, R9")
    texts = {tmp_path / "lib.so": K3K4, tmp_path / "parent.so": parent}
    monkeypatch.setattr(sass_report, "_disassemble", lambda lib: texts[lib])
    got = sass_report.report(tmp_path / "lib.so")
    bf16 = got["ppo_loss_kernel<10, 4, false, true>"]["mma"]
    assert bf16 == {"HMMA": 2, "HMMA_BF16": 2, "FFMA": 1, "LDSM": 2, "MUFU": 1, "BAR": 1}
    assert got["ppo_loss_kernel<10, 4, false, false>"]["mma"] == {
        "HMMA": 0, "HMMA_BF16": 0, "FFMA": 2, "LDSM": 0, "MUFU": 0, "BAR": 0}
    assert "HMMA 2 (bf16 2), FFMA 1, LDSM 2, MUFU 1, BAR 1" in capsys.readouterr().out
    groups = sass_report.compare(tmp_path / "lib.so", tmp_path / "parent.so")
    assert sass_report.float32_instances(groups, sass_report.PPO_LOSS_KERNELS) == {
        "same": ["ppo_update_kernel<10, 4, false, false>"],
        "differ": ["ppo_loss_kernel<10, 4, false, false>"], "missing": []}
    assert groups["differ"] == ["ppo_loss_kernel<10, 4, false, false>",
                                "ppo_loss_kernel<10, 4, false, true>"]
    assert sass_report.is_bf16_instance("ppo_update_kernel<13, 4, true, true>")
    assert not sass_report.is_bf16_instance("ppo_update_kernel<13, 4, true, false>")


#: A library with K2/K6's and K7's bf16 bodies beside their float32
#: instances, and its parent, whose float32 templates took a bf16 switch
#: as their last template argument (true in its bf16 instances).
BF16_BODIES = """
\t\tFunction : _ZN12_GLOBAL__N_123ppo_rollout_bf16_kernelIN7reinmav9Quad3dEnvELb1ELb1ELb0EEEvPKfS4_S4_S4_xijjNT_6ParamsENS_10RolloutOutEPj
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   LDSM.16.MT88.4 R8, [R3] ;
        /*0020*/                   HMMA.16816.F32.BF16 R12, R4, R8, R12 ;
        /*0030*/                   HMMA.16816.F32.BF16 R16, R4, R10, R16 ;
        /*0040*/                   MUFU.TANH R20, R21 ;
        /*0050*/                   MUFU.EX2 R22, R23 ;
        /*0060*/                   FFMA R24, R25, R26, R24 ;
        /*0070*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_118ppo_rollout_kernelIN7reinmav9Quad3dEnvELb1ELb1ELb0EEEvPKfS4_S4_S4_xijjNT_6ParamsENS_10RolloutOutE
        /*0000*/                   FFMA R6, R7, R8, R6 ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_118ppo_rollout_kernelIN7reinmav9Quad3dEnvELb1ELb1ELb1EEEvPKfS4_S4_S4_xijjNT_6ParamsENS_10RolloutOutE
        /*0000*/                   FFMA R6, R7, R10, R6 ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_129offpolicy_collect_bf16_kernelIN7reinmav8HoverEnvELi0ELb0EEEvPKf
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R12, R4, R8, R12 ;
        /*0020*/                   HMMA.16816.F32 R16, R4, R10, R16 ;
        /*0030*/                   BAR.SYNC R0, R1 ;
        /*0040*/                   BAR.ARV R2, R3 ;
        /*0050*/                   FFMA R24, R25, R26, R24 ;
        /*0060*/                   FFMA R27, R25, R26, R27 ;
        /*0070*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_124offpolicy_collect_kernelIN7reinmav8HoverEnvELi0EEEvPKf
        /*0000*/                   FFMA R6, R7, R8, R6 ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_130offpolicy_collect_count_kernelIN7reinmav10Slung2dEnvELi0EEEvPKf
        /*0000*/                   FFMA R9, R7, R8, R9 ;
        /*0010*/                   EXIT ;
"""


BF16_PARENT = """
\t\tFunction : _ZN12_GLOBAL__N_118ppo_rollout_kernelIN7reinmav9Quad3dEnvELb1ELb1ELb0ELb0EEEvPKfS4_S4_S4_xijjNT_6ParamsENS_10RolloutOutE
        /*0000*/                   FFMA R6, R7, R8, R6 ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_118ppo_rollout_kernelIN7reinmav9Quad3dEnvELb1ELb1ELb1ELb0EEEvPKfS4_S4_S4_xijjNT_6ParamsENS_10RolloutOutE
        /*0000*/                   FFMA R6, R7, R10, R6 ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_118ppo_rollout_kernelIN7reinmav9Quad3dEnvELb1ELb1ELb0ELb1EEEvPKfS4_S4_S4_xijjNT_6ParamsENS_10RolloutOutE
        /*0000*/                   FFMA R6, R7, R9, R6 ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_124offpolicy_collect_kernelIN7reinmav8HoverEnvELi0ELb0EEEvPKf
        /*0000*/                   FFMA R6, R7, R8, R6 ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_124offpolicy_collect_kernelIN7reinmav8HoverEnvELi0ELb1EEEvPKf
        /*0000*/                   FFMA R6, R7, R9, R6 ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_130offpolicy_collect_count_kernelIN7reinmav10Slung2dEnvELi0EEEvPKf
        /*0000*/                   FFMA R9, R7, R10, R9 ;
        /*0010*/                   EXIT ;
"""


def test_k2k6_k7_bf16_product_counts_and_the_float32_instances_against_a_parent(
        monkeypatch, tmp_path, capsys):
    """The bf16 bodies of K2/K6 and K7 are reported by their products'
    counts (HMMA, the bf16 ones apart, FFMA, LDSM, MUFU, BAR), not by
    their loops; with --against, the float32 K2/K6 and K7 instances that
    are the parent's instruction for instruction (the parent's named with
    their bf16 switch, false, which this tree's templates dropped; a K2/K6
    counting instance, last argument true, is float32), the ones that
    differ, and the parent's bf16 instances of the float32 template left
    out."""
    texts = {tmp_path / "lib.so": BF16_BODIES, tmp_path / "parent.so": BF16_PARENT}
    monkeypatch.setattr(sass_report, "_disassemble", lambda lib: texts[lib])
    got = sass_report.report(tmp_path / "lib.so")
    k2 = got["ppo_rollout_bf16_kernel<reinmav::Quad3dEnv, true, true, false>"]
    assert k2["mma"] == {"HMMA": 2, "HMMA_BF16": 2, "FFMA": 1, "LDSM": 2, "MUFU": 2, "BAR": 0}
    assert k2["loops"] == [] and k2["substep"] is None
    k7 = got["offpolicy_collect_bf16_kernel<reinmav::HoverEnv, 0, false>"]
    assert k7["mma"] == {"HMMA": 2, "HMMA_BF16": 1, "FFMA": 2, "LDSM": 1, "MUFU": 0, "BAR": 2}
    assert "k7" not in k7 and "k7" in got["offpolicy_collect_kernel<reinmav::HoverEnv, 0>"]
    assert "HMMA 2 (bf16 2), FFMA 1, LDSM 2, MUFU 2, BAR 0" in capsys.readouterr().out
    groups = sass_report.compare(tmp_path / "lib.so", tmp_path / "parent.so")
    assert groups["only_lib"] == ["offpolicy_collect_bf16_kernel<reinmav::HoverEnv, 0, false>",
                                  "ppo_rollout_bf16_kernel<reinmav::Quad3dEnv, true, true, false>"]
    assert groups["only_other"] == [
        "offpolicy_collect_kernel<reinmav::HoverEnv, 0, true>",
        "ppo_rollout_kernel<reinmav::Quad3dEnv, true, true, false, true>"]
    assert sass_report.float32_instances(groups, sass_report.FLOAT32_FAMILIES["K2/K6"]) == {
        "same": ["ppo_rollout_kernel<reinmav::Quad3dEnv, true, true, false>",
                 "ppo_rollout_kernel<reinmav::Quad3dEnv, true, true, true>"],
        "differ": [], "missing": []}
    assert sass_report.float32_instances(groups, sass_report.FLOAT32_FAMILIES["K7"]) == {
        "same": ["offpolicy_collect_kernel<reinmav::HoverEnv, 0>"],
        "differ": ["offpolicy_collect_count_kernel<reinmav::Slung2dEnv, 0>"], "missing": []}


def test_wide_k3k4_instances_are_a_family_of_their_own():
    """K3's and K4's wide instances (``ppo_loss_wide_kernel<kl, bf16>``)
    count as K3/K4 product kernels, their bf16 switch the last template
    argument, and ``--against`` lists their float32 instances apart from
    the 64-wide ones'."""
    assert "ppo_update_wide_kernel<false, true>".startswith(sass_report.MMA_KERNELS)
    assert sass_report.is_bf16_instance("ppo_loss_wide_kernel<true, true>")
    assert not sass_report.is_bf16_instance("ppo_loss_wide_kernel<true, false>")
    groups = {"same": ["ppo_loss_kernel<10, 4, false, false>"],
              "differ": ["ppo_update_wide_kernel<false, false>",
                         "ppo_update_wide_kernel<false, true>"],
              "only_lib": ["ppo_loss_wide_kernel<true, false>"], "only_other": []}
    assert sass_report.float32_instances(groups, sass_report.FLOAT32_FAMILIES["K3/K4 wide"]) == {
        "same": [], "differ": ["ppo_update_wide_kernel<false, false>"],
        "missing": ["ppo_loss_wide_kernel<true, false>"]}
    assert sass_report.float32_instances(groups, sass_report.FLOAT32_FAMILIES["K3/K4"]) == {
        "same": ["ppo_loss_kernel<10, 4, false, false>"], "differ": [], "missing": []}
