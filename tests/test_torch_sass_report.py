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
