"""The SASS of the closed-loop kernels K1, K5, K10 and K8/K9, of the fused
PPO rollout K2/K6 and of the off-policy collection K7: each loop of each
kernel with its static instruction count by pipe, and the substep loop
(K1, K8/K9: the horizon loop, with its reset block counted apart; K2/K6:
the horizon loop split into its blocks; K7: its phases, :func:`k7_counts`).

Run on a machine with the CUDA toolkit, from the root of a checkout::

    python3 -m reinmav_tpu_torch.sass_report [LIB] [--out DIR] [--against OTHER_LIB]
        [--blocks [--src CSRC]]

It disassembles the kernel library (``LIB``, or this checkout's, built by
``_build.build``) with ``cuobjdump -sass``, prints ptxas's registers and
spills of the kernels where the build's ptxas report lies beside the
library, and lists every loop of each kernel (a backward branch and its
target) with its static instruction count split into the FP32/INT pipes,
MUFU (with the conversions, which share its quarter-rate pipe), and
branch/other (memory, shuffles, barriers, control).  The substep loop is
the innermost loop that holds a MUFU instruction; its count excludes the
loops nested in it (the slow argument reduction of sinf/cosf).  The
closed-loop template's horizon loop (``closed_loop_kernel<...>``) is
that loop too; its reset block, the Philox rounds of the auto-reset, is
the span from the loop's first to its last multiply by a Philox constant
(nested loops included), counted by pipe beside the loop.  K2/K6's
horizon loop is the outermost loop that holds a MUFU instruction (its
tanhf sit in the nested tower and hidden-unit loops), and
:func:`env_step_count` weighs its loop levels into the instructions an
env-step.  A static count: a block that a branch skips on most substeps (a
slow path, the reset) is counted as if it ran.  K7's report
(``offpolicy_collect_kernel<...>`` and its counting instances) names its
W2 loop (FFMA to LDS.128 a pass), its copies through registers (the LDG
in flight before the first STS) and asynchronous copies (LDGSTS), its
first layer's loop (LDS an FFMA) and phase 4 after the last barrier (the
action, env step, block and reset, its Philox spans apart).
K3's and K4's instances (``ppo_loss_kernel<D, A, kl, bf16>``,
``ppo_update_kernel<...>``, and the wide ones ``ppo_loss_wide_kernel<kl,
bf16>``, ``ppo_update_wide_kernel<...>``) and the bf16 bodies of K2/K6 and K7
(``ppo_rollout_bf16_kernel<...>``, ``offpolicy_collect_bf16_kernel<...>``)
get one line each: their tensor-core products (``HMMA``, the bf16 ones
apart) beside their ``FFMA``, with the ``ldmatrix`` loads (``LDSM``),
``MUFU`` and barriers (:func:`mma_counts`).  ``chip_smoke.py`` calls
:func:`report` on the library it built.  With ``--against``, it also lists which kernels of
the two libraries have the same SASS, instruction for instruction (such a
kernel gives the same bits on every input), and which differ, and the
float32 instances of K3/K4, K2/K6 and K7 apart (:func:`float32_instances`).

``--blocks`` splits the horizon loop of K2/K6 (``ppo_rollout_kernel<...>``)
into the blocks of its source: the MLP (the two towers' products),
``tanhf``, the Philox/Box-Muller noise, the env step with the reward, the
reset, and the rest (obs normalisation, moment sums, stores, loop
control).  It compiles ``ppo_rollout.cu`` (of ``--src``, default this
checkout's) once more with ``-lineinfo`` into a cubin, which must hold the
library's instructions, and attributes each instruction of the loop by
``nvdisasm``'s line table to the source line in the kernel's own file that
it was inlined at (:func:`block_counts`).  Each block is counted at the
three loop levels of an env-step: the horizon loop's own body, the tower
loop (2 passes an env-step) and the hidden-unit loop (``64 / units a
pass`` passes a tower); loops nested deeper are slow paths, counted apart.
It also prints each kernel's resident CTAs an SM from libcuda's
``cuOccupancyMaxActiveBlocksPerMultiprocessor`` on that cubin (a card is
needed).
"""

from __future__ import annotations

import argparse
import re
import subprocess
from pathlib import Path

MUFU = ("MUFU", "F2I", "I2F", "F2F", "FRND", "I2I")
OTHER = ("BRA", "BRX", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "NOP", "BAR", "WARPSYNC", "YIELD",
         "S2R", "S2UR", "CS2R", "LD", "ST", "LDG", "STG", "LDS", "STS", "LDC", "ULDC", "SHFL",
         "MEMBAR", "DEPBAR", "VOTE", "VOTEU", "REDUX", "ATOM", "ATOMS", "RED", "MATCH", "BMOV",
         "BREAK", "KILL", "ELECT", "ERRBAR", "CCTL", "R2UR", "UMOV", "UIADD3", "ULOP3", "USHF",
         "UISETP", "USEL", "ULEA", "UIMAD", "UPRMT", "UFLO", "UPOPC", "USGXT", "UBMSK", "PLOP3U")
KERNELS = ("hover_rollout_kernel", "reinmav_rollout_kernel", "reinmav_rollout_lanes_kernel",
           "closed_loop_kernel", "ppo_rollout_kernel", "ppo_rollout_bf16_kernel",
           "offpolicy_collect_kernel", "offpolicy_collect_count_kernel",
           "offpolicy_collect_bf16_kernel", "offpolicy_collect_wide_kernel")
#: K3's and K4's kernel families (one instance per obs and action dim, mode
#: and compute dtype).
PPO_LOSS_KERNELS = ("ppo_loss_kernel", "ppo_update_kernel")
#: K3's and K4's wide instances (two equal hidden widths taken at run time:
#: one instance per mode and compute dtype, the dtype their last template
#: argument), and K3 wide's packing of the weights into mma fragments (one
#: instance per dtype).
WIDE_KERNELS = ("ppo_loss_wide_kernel", "ppo_update_wide_kernel", "ppo_wide_pack_kernel")
#: The bf16 bodies of K2/K6 and K7 (and K7 wide) on the tensor cores (one
#: instance per kind, normalisers or mode, and probe).
BF16_KERNELS = ("ppo_rollout_bf16_kernel", "offpolicy_collect_bf16_kernel",
                "offpolicy_collect_wide_bf16_kernel")
#: The families whose report is their products' counts (:func:`mma_counts`).
MMA_KERNELS = PPO_LOSS_KERNELS + WIDE_KERNELS + BF16_KERNELS
#: The float32 instances that ``--against`` lists apart, by kernel: K3/K4's
#: and their wide ones' (the bf16 ones left out by their last template
#: argument), K2/K6's and K7's (whose bf16 instances are families of their
#: own).
FLOAT32_FAMILIES = {"K3/K4": PPO_LOSS_KERNELS, "K2/K6": ("ppo_rollout_kernel",),
                    "K7": ("offpolicy_collect_kernel", "offpolicy_collect_count_kernel"),
                    "K3/K4 wide": WIDE_KERNELS, "K7 wide": ("offpolicy_collect_wide_kernel",)}
#: The float32 templates of K2/K6 and K7 that took a bf16 switch as their
#: last template argument until their bf16 instances got bodies of their
#: own, by their number of template arguments then
#: (``ppo_rollout_kernel<Env, obs, rew, count, bf16>``,
#: ``offpolicy_collect_kernel<Env, mode, bf16>``): ``--against`` a library
#: built before that pairs its float32 instances with this tree's.
OLD_BF16_SWITCH = {"ppo_rollout_kernel": 5, "offpolicy_collect_kernel": 3}
#: Threads a CTA of each kernel family (for the occupancy query).
CTA_THREADS = {"ppo_rollout_kernel": 128, "closed_loop_kernel": 256,
               "ppo_rollout_bf16_kernel": 256, "offpolicy_collect_bf16_kernel": 320}
#: Philox4x32's two multipliers as SASS prints an immediate: unsigned, or as
#: the signed 32-bit value.
PHILOX_IMMEDIATES = ("0xd2511f53", "-0x2daee0ad", "0xcd9e8d57", "-0x326172a9")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+|\$[^:\s]+):")
_TARGET = re.compile(r"`\(([^)]+)\)")


def opcode_class(op: str) -> str:
    """``fp32/int``, ``mufu`` (with the conversions) or ``other``."""
    base = op.split(".")[0]
    if base in MUFU:
        return "mufu"
    if base in OTHER or base.startswith(("LD", "ST", "U")):
        return "other"
    return "fp32/int"


def parse_functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """cuobjdump -sass text -> {mangled name: [(address, opcode, operands)]},
    branch targets as absolute addresses (``0x...``), labels resolved."""
    out: dict[str, list] = {}
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        insns, labels, pending = [], {}, []
        for line in body.splitlines():
            m = _LABEL.match(line)
            if m:
                pending.append(m.group(1))
                continue
            m = _INSN.search(line)
            if m:
                addr = int(m.group(1), 16)
                for label in pending:
                    labels[label] = addr
                pending = []
                insns.append((addr, m.group(3), m.group(4)))
        out[name.strip()] = [
            (a, op, _TARGET.sub(lambda t: hex(labels.get(t.group(1), 0)), args))
            for a, op, args in insns]
    return out


def loops(insns) -> list[dict]:
    """Every backward branch of a function as a loop ``[start, end]`` with
    its instruction count by class; the loops nested in it are listed in
    ``inner``."""
    found = []
    for addr, op, args in insns:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            found.append((int(m.group(1), 16), addr))
    rows = []
    for start, end in found:
        body = [(a, op) for a, op, _ in insns if start <= a <= end]
        inner = [(s, e) for s, e in found if start <= s and e <= end and (s, e) != (start, end)]
        flat = [(a, op) for a, op in body if not any(s <= a <= e for s, e in inner)]
        counts = {"fp32/int": 0, "mufu": 0, "other": 0}
        for _, op in flat:
            counts[opcode_class(op)] += 1
        rows.append({"start": start, "end": end, "n": len(flat), **counts, "inner": inner,
                     "mufu_ops": sorted({op for _, op in flat if op.startswith("MUFU")})})
    return rows


def substep_loop(rows: list[dict]) -> dict | None:
    """The innermost loop that holds a MUFU instruction."""
    with_mufu = [r for r in rows if any(op.startswith("MUFU") for op in r["mufu_ops"])]
    return min(with_mufu, key=lambda r: r["end"] - r["start"]) if with_mufu else None


def horizon_loop(rows: list[dict]) -> dict | None:
    """The outermost loop that holds a MUFU instruction, nested loops
    included (K2/K6's horizon loop: its tanhf sit in the unit loop)."""
    def has_mufu(r):
        return r["mufu_ops"] or any(
            q["mufu_ops"] for q in rows if (q["start"], q["end"]) in r["inner"])
    with_mufu = [r for r in rows if has_mufu(r)]
    return max(with_mufu, key=lambda r: r["end"] - r["start"]) if with_mufu else None


def reset_span(insns, loop: dict) -> dict | None:
    """The reset block of ``loop``: its instructions, nested loops
    included, from the first to the last integer multiply by a Philox
    constant, counted by class (None if the loop has no such multiply).
    ``in_loop`` is the part of that span that ``loop``'s own count holds
    (the part outside its nested loops)."""
    body = [(a, op, args) for a, op, args in insns if loop["start"] <= a <= loop["end"]]
    hits = [a for a, op, args in body if op.startswith("IMAD")
            and any(k in args.lower() for k in PHILOX_IMMEDIATES)]
    if not hits:
        return None
    span = [(a, op) for a, op, _ in body if hits[0] <= a <= hits[-1]]
    counts = {"fp32/int": 0, "mufu": 0, "other": 0}
    for _, op in span:
        counts[opcode_class(op)] += 1
    in_loop = sum(1 for a, _ in span if not any(s <= a <= e for s, e in loop["inner"]))
    return {"start": hits[0], "end": hits[-1], "n": len(span), **counts, "in_loop": in_loop}


# --- K7: the collection step by phase ------------------------------------------------

#: Opcode families that K7's report counts, by the opcode's first field(s).
K7_OPS = ("FFMA", "LDS.128", "LDS", "STS", "LDG", "LDGSTS", "BAR", "SHFL")


def _k7_op(op: str) -> str | None:
    """The family of ``K7_OPS`` an opcode belongs to (None: another)."""
    parts = op.split(".")
    base = parts[0]
    if base == "LDS":
        return "LDS.128" if "128" in parts[1:] else "LDS"
    return base if base in K7_OPS else None


def _k7_hist(ops) -> dict:
    out = dict.fromkeys(K7_OPS, 0)
    out["n"] = 0
    for op in ops:
        out["n"] += 1
        fam = _k7_op(op)
        if fam is not None:
            out[fam] += 1
    return out


def philox_clusters(insns, gap: int = 40) -> list[dict]:
    """The Philox spans of ``insns``: the integer multiplies by a Philox
    constant, grouped where fewer than ``gap`` instructions part two of
    them; each span from its first to its last multiply, with its
    instruction count and its multiplies (20 for one philox4x32_10 block)."""
    hits = [i for i, (_, op, args) in enumerate(insns) if op.startswith("IMAD")
            and any(k in args.lower() for k in PHILOX_IMMEDIATES)]
    spans = []
    for i in hits:
        if spans and i - spans[-1][1] < gap:
            spans[-1][1] = i
            spans[-1][2] += 1
        else:
            spans.append([i, i, 1])
    return [{"start": insns[a][0], "end": insns[b][0], "n": b - a + 1, "multiplies": m}
            for a, b, m in spans]


def k7_counts(insns) -> dict:
    """K7 (``offpolicy_collect_kernel<...>``) by phase, static counts.

    ``mlp``: the W2 loop, of the innermost loops that hold FFMA (no loop
    nested in them holds one) and LDS.128 the one with the most FFMA, a
    pass of it without its nested loops, by ``K7_OPS`` family, with
    ``ffma_per_lds128``; ``copy``: each loop without FFMA that holds both
    LDG and STS (a copy through registers), with ``ldg_before_sts``, the
    loads issued before the loop's first STS (the most in flight at once),
    and ``in_w2`` whether a loop around the W2 loop holds it too (the W2
    chunk copy); ``ldgsts``: the asynchronous copies (``cp.async``) in the
    whole kernel; ``phase2``: of the other innermost FFMA loops, the one
    with the most FFMA (the first layer), with ``lds_per_ffma``;
    ``phase4``: the instructions after the last barrier (the action, the
    env step, the block, the reset), by class, with the Philox spans in it
    (:func:`philox_clusters`) and ``without_philox``, its count less
    theirs."""
    rows = loops(insns)

    def flat(r):
        return [(a, op) for a, op, _ in insns if r["start"] <= a <= r["end"]
                and not any(s <= a <= e for s, e in r["inner"])]

    hist = {(r["start"], r["end"]): _k7_hist(op for _, op in flat(r)) for r in rows}
    innermost = [r for r in rows if hist[(r["start"], r["end"])]["FFMA"] and
                 not any(hist[se]["FFMA"] for se in r["inner"])]
    w2 = [r for r in innermost if hist[(r["start"], r["end"])]["LDS.128"]]
    mlp = max(w2, key=lambda r: hist[(r["start"], r["end"])]["FFMA"], default=None)
    out = {"mlp": None, "copy": [], "phase2": None, "phase4": None,
           "ldgsts": sum(1 for _, op, _ in insns if op.startswith("LDGSTS"))}
    around = [] if mlp is None else [r for r in rows if (mlp["start"], mlp["end"]) in r["inner"]]
    if mlp is not None:
        h = hist[(mlp["start"], mlp["end"])]
        out["mlp"] = {"start": mlp["start"], "end": mlp["end"], **h,
                      "ffma_per_lds128": h["FFMA"] / h["LDS.128"]}
    for r in rows:
        h = hist[(r["start"], r["end"])]
        if h["FFMA"] == 0 and h["LDG"] and h["STS"]:
            ops = [op for _, op in flat(r)]
            first_sts = next(i for i, op in enumerate(ops) if _k7_op(op) == "STS")
            out["copy"].append({
                "start": r["start"], "end": r["end"], **h,
                "ldg_before_sts": sum(1 for op in ops[:first_sts] if _k7_op(op) == "LDG"),
                "in_w2": any((r["start"], r["end"]) in q["inner"] for q in around)})
    rest = [r for r in innermost if r is not mlp]
    p2 = max(rest, key=lambda r: hist[(r["start"], r["end"])]["FFMA"], default=None)
    if p2 is not None:
        h = hist[(p2["start"], p2["end"])]
        out["phase2"] = {"start": p2["start"], "end": p2["end"], **h,
                         "lds_per_ffma": (h["LDS"] + h["LDS.128"]) / h["FFMA"]}
    bars = [i for i, (_, op, _) in enumerate(insns) if op.startswith("BAR")]
    if bars:
        tail = insns[bars[-1] + 1:]
        counts = {"n": len(tail), "fp32/int": 0, "mufu": 0, "other": 0}
        for _, op, _ in tail:
            counts[opcode_class(op)] += 1
        spans = philox_clusters(tail)
        out["phase4"] = {**counts, "philox": spans,
                         "without_philox": len(tail) - sum(s["n"] for s in spans)}
    return out


def k7_line(k7: dict) -> str:
    """One line of :func:`k7_counts`: the W2 loop a pass, the copies, the
    first layer's loop and phase 4."""
    fam = lambda h: ", ".join(f"{k} {h[k]}" for k in ("n", *K7_OPS) if h[k])  # noqa: E731
    parts = []
    m = k7["mlp"]
    if m is not None:
        parts.append(f"W2 loop {m['start']:#07x}-{m['end']:#07x} a pass: {fam(m)}, "
                     f"{m['ffma_per_lds128']:g} FFMA an LDS.128")
    for c in k7["copy"]:
        parts.append(f"{'W2 chunk' if c['in_w2'] else 'staging'} copy loop "
                     f"{c['start']:#07x}-{c['end']:#07x} a pass: {fam(c)}, "
                     f"{c['ldg_before_sts']} LDG before its first STS")
    parts.append(f"cp.async (LDGSTS) {k7['ldgsts']}")
    p2 = k7["phase2"]
    if p2 is not None:
        parts.append(f"first-layer loop {p2['start']:#07x}-{p2['end']:#07x} a pass: {fam(p2)}, "
                     f"{p2['lds_per_ffma']:.3g} LDS an FFMA")
    p4 = k7["phase4"]
    if p4 is not None:
        parts.append(f"phase 4 (after the last barrier) {p4['n']} (fp32/int {p4['fp32/int']}, "
                     f"mufu {p4['mufu']}, other {p4['other']}), Philox spans "
                     f"{[(s['n'], s['multiplies']) for s in p4['philox']]} (instructions, "
                     f"multiplies), {p4['without_philox']} without them")
    return "; ".join(parts)


# --- K2/K6's horizon loop by block, from a -lineinfo build ------------------------

BLOCKS = ("mlp", "tanhf", "noise", "env step", "reset", "other")
LEVELS = ("horizon", "tower", "unit", "slow")
_SECTION = re.compile(r"^\s*\.section\s+\.text\.([^,\s]+)")
_LINEINFO = re.compile(r"//##\s*File")
_FRAME = re.compile(r'"([^"]+)",\s*line\s+(\d+)')
#: Functions of the shared headers whose code is the reset's or the noise's
#: draws, by name (the rest of a header's code is the env step's).
_DRAWS = ("philox4x32_10", "uniform01", "uniform_pm1", "reset_uniform")
_RESETS = ("hover_reset",)
_FUNC = re.compile(r"^(?:template\s*<[^>]*>\s*)?(?:__device__|__host__|inline|static|"
                   r"__forceinline__|\s)+[\w:<>,\s&*]+?\b(\w+)\s*\(")


def parse_lineinfo(text: str) -> dict[str, list[tuple[int, str, str, list]]]:
    """``nvdisasm -g`` (or ``-gi``) text -> {mangled name: [(address,
    opcode, operands, frames)]}: ``frames`` the ``(file, line)`` of the
    line-table comment above the instruction, innermost first (with
    ``-gi``, the lines it was inlined at follow), branch targets resolved
    as in :func:`parse_functions`."""
    out: dict[str, list] = {}
    name, insns, labels, pending, frames = None, [], {}, [], []

    def close():
        if name is not None:
            out[name] = [(a, op, _TARGET.sub(lambda t: hex(labels.get(t.group(1), 0)), args), f)
                         for a, op, args, f in insns]

    for line in text.splitlines():
        m = _SECTION.match(line)
        if m:
            close()
            name, insns, labels, pending, frames = m.group(1), [], {}, [], []
            continue
        if name is None:
            continue
        if _LINEINFO.search(line):
            frames = [(f, int(n)) for f, n in _FRAME.findall(line)]
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            insns.append((addr, m.group(3), m.group(4), frames))
    close()
    return out


def source_blocks(source: str) -> dict[int, str]:
    """Line number (1-based) -> block of K2/K6's horizon loop, from the
    markers of ``ppo_rollout.cu``'s text: the lines from "The actor-critic"
    to "Gaussian action" are the MLP (a line that calls ``tanhf`` is
    ``tanhf``), from there to "Env step." the noise, from there to the line
    that calls ``Env::reset`` the env step with the reward, that line the
    reset; the other lines are ``other``."""
    lines = source.splitlines()

    def first(marker, start=0):
        for i in range(start, len(lines)):
            if marker in lines[i]:
                return i
        raise ValueError(f"marker {marker!r} not in the source")

    mlp = first("The actor-critic")
    noise = first("Gaussian action", mlp)
    step = first("Env step.", noise)
    reset = first("Env::reset(", step)
    out = {}
    for i, text in enumerate(lines):
        block = ("other" if i < mlp or i > reset else
                 ("tanhf" if "tanhf(" in text else "mlp") if i < noise else
                 "noise" if i < step else "env step" if i < reset else "reset")
        out[i + 1] = block
    return out


def header_functions(source: str) -> dict[int, str]:
    """Line number (1-based) -> the name of the function whose definition
    the line lies in, for a header of device functions (a definition starts
    at a line of column 0 that declares a function; it runs to the next)."""
    out, current = {}, ""
    for i, text in enumerate(source.splitlines()):
        m = _FUNC.match(text)
        if m and not text.startswith((" ", "\t", "}")):
            current = m.group(1)
        out[i + 1] = current
    return out


def block_counts(insns, kernel_file: str, source: str, headers: dict[str, str]) -> dict:
    """The horizon loop of one K2/K6 instance (``insns`` from
    :func:`parse_lineinfo`) by block and loop level: ``{"counts": {block:
    {level: n}}, "units": units a pass of the unit loop, "per_env_step":
    {block: instructions an env-step issues}, "unattributed": n}``.

    An instruction belongs to the block of the outermost line-table frame
    in ``kernel_file`` (by basename; :func:`source_blocks` of ``source``).
    Without such a frame (``nvdisasm -g`` without the inline frames), code
    of a header's draw functions is the noise before the first env-step
    instruction and the reset after it, a header's reset function the
    reset, any other code of a header (``headers``: basename -> text) the
    env step.  Loop levels: the tower loop is the loop nested in the horizon
    loop that holds the most MLP instructions, the unit loop the one nested
    in it that holds the most; other nested loops are slow paths.  The unit
    loop makes ``64 / units`` passes a tower (:func:`units_per_pass`)."""
    from pathlib import PurePath

    base = PurePath(kernel_file).name
    by_line = source_blocks(source)
    funcs = {name: header_functions(text) for name, text in headers.items()}
    rows = loops([(a, op, args) for a, op, args, _ in insns])
    top = horizon_loop(rows)
    if top is None:
        raise ValueError("no horizon loop (no loop holds a MUFU instruction)")
    body = [x for x in insns if top["start"] <= x[0] <= top["end"]]
    blocks, pending, unattributed = {}, [], 0
    for a, op, _, frames in body:
        own = [ln for f, ln in frames if PurePath(f).name == base]
        if own:
            blocks[a] = by_line.get(own[-1], "other")
            continue
        block = None
        for f, ln in frames:
            if PurePath(f).name not in funcs:
                continue  # the toolkit's headers: the frame that called them decides
            fn = funcs[PurePath(f).name].get(ln)
            block = "reset" if fn in _RESETS else "draw" if fn in _DRAWS else "env step"
            break
        if block is None:
            unattributed += 1
            block = "other"
        blocks[a] = block
        if block == "draw":
            pending.append(a)
    first_step = min((a for a, b in blocks.items() if b == "env step"), default=None)
    for a in pending:
        blocks[a] = "noise" if first_step is None or a < first_step else "reset"

    level = loop_levels(rows, top)
    counts = {b: dict.fromkeys(LEVELS, 0) for b in BLOCKS}
    for a, op, _, _ in body:
        counts[blocks[a]][level(a)] += 1
    units = units_per_pass([(a, op) for a, op, _, _ in body], level)
    passes = 64 // units if units else 0
    per_step = {b: c["horizon"] + 2 * c["tower"] + 2 * passes * c["unit"]
                for b, c in counts.items()}
    return {"counts": counts, "units": units, "per_env_step": per_step,
            "unattributed": unattributed}


def loop_levels(rows: list[dict], top: dict):
    """``level(address)`` of K2/K6's horizon loop ``top``: ``horizon`` (its
    own body), ``tower`` (the largest loop nested in it), ``unit`` (the
    largest loop nested in the tower loop) or ``slow`` (any other nested
    loop: a library's slow path)."""
    def size(r):
        return r["end"] - r["start"]

    nested = [r for r in rows if (r["start"], r["end"]) in top["inner"]]
    tower = max(nested, key=size, default=None)
    inner = [] if tower is None else [
        r for r in nested if (r["start"], r["end"]) in tower["inner"]]
    unit = max(inner, key=size, default=None)

    def level(a):
        around = [r for r in nested if r["start"] <= a <= r["end"]]
        if not around:
            return "horizon"
        if unit is not None and unit in around and all(r in (tower, unit) for r in around):
            return "unit"
        return "tower" if around == [tower] else "slow"

    return level


def units_per_pass(insns, level) -> int:
    """Hidden units a pass of K2/K6's unit loop: its ``tanhf`` calls, one a
    unit, each one MUFU.EX2 (0 where there is no unit loop)."""
    return sum(1 for a, op in insns if level(a) == "unit" and op.startswith("MUFU.EX2"))


def env_step_count(insns) -> dict:
    """Instructions an env-step of K2/K6's horizon loop issues at most
    without its slow paths, from the loop levels of :func:`loop_levels`:
    the horizon loop's own body, the tower loop's twice, the unit loop's
    ``2 * 64 / units`` times (:func:`units_per_pass`), by class;
    ``static`` the horizon loop's instructions, nested loops included."""
    rows = loops(insns)
    top = horizon_loop(rows)
    if top is None:
        raise ValueError("no horizon loop (no loop holds a MUFU instruction)")
    level = loop_levels(rows, top)
    units = units_per_pass([(a, op) for a, op, _ in insns
                            if top["start"] <= a <= top["end"]], level)
    weight = {"horizon": 1, "tower": 2, "unit": 2 * (64 // units) if units else 0, "slow": 0}
    out = {"per_env_step": 0, "units": units, "fp32/int": 0, "mufu": 0, "other": 0,
           "static": 0}
    for a, op, _ in insns:
        if top["start"] <= a <= top["end"]:
            w = weight[level(a)]
            out["static"] += 1
            out["per_env_step"] += w
            out[opcode_class(op)] += w
    return out


def lineinfo_build(src: Path, out_dir: Path) -> tuple[Path, str]:
    """Compile ``src`` with the library's flags and ``-lineinfo`` into a
    cubin in ``out_dir``; returns it and ``nvdisasm``'s text of it with the
    line table (inline frames where this nvdisasm prints them)."""
    from . import _build

    nvcc = _build._nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / (src.stem + ".lineinfo.cubin")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, *_build.SOURCE_FLAGS.get(src.name, ()), "-lineinfo", "-cubin",
                    "-o", str(cubin), str(src)], check=True, capture_output=True, text=True,
                   timeout=900)
    nvdisasm = str(Path(nvcc).parent / "nvdisasm")
    for opts in (["-g", "-gi"], ["-g"]):
        run = subprocess.run([nvdisasm, *opts, "-c", str(cubin)], capture_output=True,
                             text=True, timeout=600)
        if run.returncode == 0:
            cubin.with_suffix(".nvdisasm.txt").write_text(run.stdout)
            return cubin, run.stdout
    raise RuntimeError(f"nvdisasm failed on {cubin}: {run.stderr}")


def occupancy(cubin: Path, kernels: dict[str, int]) -> dict[str, dict]:
    """Resident CTAs an SM of each kernel of ``cubin`` (mangled name -> CTA
    threads), no dynamic shared memory, by libcuda's
    ``cuOccupancyMaxActiveBlocksPerMultiprocessor``, with its registers
    (``cuFuncGetAttribute``); the card's primary context is made current
    through torch."""
    import ctypes

    import torch

    torch.zeros(1, device="cuda")  # the primary context, current on this thread
    cu = ctypes.CDLL("libcuda.so.1")
    module = ctypes.c_void_p()
    data = cubin.read_bytes()
    rc = cu.cuModuleLoadData(ctypes.byref(module), ctypes.c_char_p(data))
    if rc != 0:
        raise RuntimeError(f"cuModuleLoadData: CUresult {rc}")
    out = {}
    try:
        for name, threads in kernels.items():
            func, n, regs = ctypes.c_void_p(), ctypes.c_int(), ctypes.c_int()
            rc = cu.cuModuleGetFunction(ctypes.byref(func), module, name.encode())
            rc = rc or cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                ctypes.byref(n), func, ctypes.c_int(threads), ctypes.c_size_t(0))
            rc = rc or cu.cuFuncGetAttribute(ctypes.byref(regs), 4, func)  # NUM_REGS
            if rc != 0:
                raise RuntimeError(f"occupancy of {name}: CUresult {rc}")
            out[name] = {"threads": threads, "ctas_per_sm": n.value, "registers": regs.value,
                         "warps_per_scheduler": n.value * threads / 32 / 4}
    finally:
        cu.cuModuleUnload(module)
    return out


def blocks_report(src_dir: Path, lib: Path | None, out_dir: Path) -> dict[str, dict]:
    """Print and return, for each float32 K2/K6 instance of ``src_dir``'s
    ``ppo_rollout.cu`` and each K1 instance of ``closed_loop_rollout.cu``
    (``closed_loop_kernel<Quad3dLoop...>``), the -lineinfo build's
    registers, resident CTAs an SM and warps a scheduler; for K2/K6 the
    horizon loop by block and level (:func:`block_counts`); and whether
    each kernel's instructions are the library ``lib``'s (when given)."""
    headers = {p.name: p.read_text() for p in sorted(src_dir.glob("*.cuh"))}
    ours = _disassemble(lib) if lib is not None else None
    lib_funcs = parse_functions(ours) if ours is not None else {}
    lib_ops = {short_name(p): [op for _, op, _ in lib_funcs[m]]
               for m, p in zip(lib_funcs, demangle(list(lib_funcs)))}
    result = {}
    for src_name, family in (("ppo_rollout.cu", "ppo_rollout_kernel"),
                             ("closed_loop_rollout.cu", "closed_loop_kernel")):
        src = src_dir / src_name
        if not src.exists():
            continue
        cubin, text = lineinfo_build(src, out_dir)
        funcs = parse_lineinfo(text)
        names = list(funcs)
        pretty = dict(zip(names, (short_name(p) for p in demangle(names))))
        chosen = {m: CTA_THREADS[family] for m in names if pretty[m].startswith(family)
                  and (family != "closed_loop_kernel" or "Quad3d" in pretty[m])}
        if not chosen:
            continue
        occ = occupancy(cubin, chosen)
        for m in chosen:
            short = pretty[m]
            ops = [op for _, op, _, _ in funcs[m]]
            same = None if lib is None else lib_ops.get(short) == ops
            o = occ[m]
            print(f"blocks: {short}: {o['registers']} registers, {o['ctas_per_sm']} CTAs of "
                  f"{o['threads']} threads an SM, {o['warps_per_scheduler']:g} warps a scheduler; "
                  f"the -lineinfo build's instructions the library's: {same}")
            row = {**o, "same_as_library": same}
            if family == "ppo_rollout_kernel":
                b = block_counts(funcs[m], src_name, src.read_text(), headers)
                for block in BLOCKS:
                    c = b["counts"][block]
                    print(f"blocks:   {block}: horizon {c['horizon']}, tower {c['tower']}, unit "
                          f"{c['unit']}, slow {c['slow']}; an env-step "
                          f"{b['per_env_step'][block]}")
                print(f"blocks:   unit loop {b['units']} units a pass; an env-step "
                      f"{sum(b['per_env_step'].values())} instructions without slow paths; "
                      f"{b['unattributed']} unattributed")
                row.update(b)
            result[short] = row
    return result


def short_name(pretty: str) -> str:
    """A demangled kernel name without its namespace, return type and
    arguments: ``closed_loop_kernel<Quad2dLoop, false>``."""
    return pretty.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


def demangle(names: list[str]) -> list[str]:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
    except OSError:
        return names
    return out if len(out) == len(names) else names


def mma_counts(insns) -> dict:
    """The static count of a kernel's product and feed instructions:
    ``HMMA`` (tensor-core products) and ``HMMA_BF16`` (those on bf16
    operands), ``FFMA``, ``LDSM`` (ldmatrix), ``MUFU`` and ``BAR``."""
    out = dict.fromkeys(("HMMA", "HMMA_BF16", "FFMA", "LDSM", "MUFU", "BAR"), 0)
    for _, op, _ in insns:
        base = op.split(".")[0]
        if base == "HMMA":
            out["HMMA"] += 1
            out["HMMA_BF16"] += ".BF16" in op
        elif base in out:
            out[base] += 1
    return out


def template_args(short: str) -> tuple[str, list[str]]:
    """A short name's family and its template arguments, outermost level:
    ``("closed_loop_kernel", ["Quad3dLoop<true>", "false"])``."""
    family, _, rest = short.partition("<")
    args, depth, arg = [], 0, ""
    for c in rest[:-1]:
        depth += (c == "<") - (c == ">")
        if c == "," and depth == 0:
            args.append(arg.strip())
            arg = ""
        else:
            arg += c
    return family, args + [arg.strip()] if rest else []


def today_name(short: str) -> str:
    """A kernel's name as this tree's library gives it: a float32 instance
    of a library built before the bf16 bodies of K2/K6 and K7
    (``ppo_rollout_kernel<..., false>``, its last template argument the
    bf16 switch of :data:`OLD_BF16_SWITCH`) without that switch; any other
    name as it is."""
    family, args = template_args(short)
    if OLD_BF16_SWITCH.get(family) == len(args) and args[-1] == "false":
        return f"{family}<{', '.join(args[:-1])}>"
    return short


def is_bf16_instance(short: str) -> bool:
    """Whether a K3/K4 instance's name (``ppo_loss_kernel<10, 4, false,
    true>``, ``ppo_loss_wide_kernel<false, true>``) is its bf16 instance:
    the last template argument (so too a K2/K6 or K7 instance of a library
    built before their bf16 bodies, ``ppo_rollout_kernel<..., true>``, by
    :data:`OLD_BF16_SWITCH`)."""
    family, args = template_args(short)
    switch = (family in PPO_LOSS_KERNELS + WIDE_KERNELS
              or OLD_BF16_SWITCH.get(family) == len(args))
    return switch and args[-1] == "true"


def float32_instances(groups: dict[str, list[str]],
                      families: tuple[str, ...]) -> dict[str, list[str]]:
    """Of :func:`compare`'s groups, the float32 instances of the kernel
    ``families``: ``same``, ``differ`` and ``missing`` (in one library
    only)."""
    def pick(names):
        return [n for n in names if n.startswith(tuple(f + "<" for f in families))
                and not is_bf16_instance(n)]

    return {"same": pick(groups["same"]), "differ": pick(groups["differ"]),
            "missing": pick(groups["only_lib"] + groups["only_other"])}



def _disassemble(lib: Path) -> str:
    from . import _build

    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=600).stdout


def compare(lib: Path, other: Path) -> dict[str, list[str]]:
    """The kernels of ``lib`` whose SASS is ``other``'s instruction for
    instruction (``same``), the ones in both that differ (``differ``), and
    the ones in one library only (``only_lib``, ``only_other``), by their
    short demangled names (nvcc mangles a kernel of an anonymous namespace
    with a prefix of its own build), as this tree names them
    (:func:`today_name`)."""

    def by_name(path: Path) -> dict:
        funcs = parse_functions(_disassemble(path))
        return {today_name(short_name(pretty)): funcs[m]
                for m, pretty in zip(funcs, demangle(list(funcs)))}

    a, b = by_name(lib), by_name(other)
    group = {"same": [], "differ": [], "only_lib": [], "only_other": []}
    for n in sorted(set(a) | set(b)):
        key = ("only_other" if n not in a else "only_lib" if n not in b else
               "same" if a[n] == b[n] else "differ")
        group[key].append(n)
    return group


def report(lib: Path, out_dir: Path | None = None) -> dict[str, dict]:
    """Disassemble ``lib`` with the ``cuobjdump`` beside nvcc; print and
    return each K1/K5/K10/K8/K9/K2/K6/K7 kernel's loops, its substep loop's
    counts (K2/K6: its horizon loop's; K7: none, its phases under ``k7``,
    :func:`k7_counts`), that loop's reset block (:func:`reset_span`, None
    where it has none) and its instructions, and each instance of K3/K4
    and of the bf16 bodies of K2/K6 and K7 (:data:`MMA_KERNELS`) with its
    :func:`mma_counts` (under ``mma``) and instructions, keyed by the
    demangled name.
    With ``out_dir``, each kernel's SASS is written there."""
    funcs = parse_functions(_disassemble(lib))
    names = list(funcs)
    result = {}
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    for mangled, pretty in zip(names, demangle(names)):
        short = short_name(pretty)
        insns = funcs[mangled]
        k3k4 = short.startswith(MMA_KERNELS)
        if not k3k4 and not any(k in short for k in KERNELS):
            continue
        where = ""
        if out_dir is not None:
            path = out_dir / (re.sub(r"[^A-Za-z0-9_]+", "_", short).strip("_") + ".sass")
            path.write_text("\n".join(f"/*{a:05x}*/ {op} {args}" for a, op, args in insns) + "\n")
            where = f" ({path})"
        if k3k4:
            mma = mma_counts(insns)
            print(f"sass: {short}: {len(insns)} instructions, HMMA {mma['HMMA']} (bf16 "
                  f"{mma['HMMA_BF16']}), FFMA {mma['FFMA']}, LDSM {mma['LDSM']}, MUFU "
                  f"{mma['MUFU']}, BAR {mma['BAR']}{where}")
            result[short] = {"loops": [], "substep": None, "reset": None, "insns": insns,
                             "mma": mma}
            continue
        rows = loops(insns)
        print(f"sass: {short}: {len(insns)} instructions, {len(rows)} loops{where}")
        for r in sorted(rows, key=lambda r: r["start"]):
            print(f"sass:   loop {r['start']:#07x}-{r['end']:#07x}: {r['n']} instructions "
                  f"(fp32/int {r['fp32/int']}, mufu {r['mufu']}, other {r['other']}; "
                  f"{len(r['inner'])} nested loops excluded; {' '.join(r['mufu_ops'])})")
        if "offpolicy_collect" in short:
            k7 = k7_counts(insns)
            print(f"sass:   K7 {k7_line(k7)}")
            result[short] = {"loops": rows, "substep": None, "reset": None, "insns": insns,
                             "k7": k7}
            continue
        sub = (horizon_loop if "ppo_rollout_kernel" in short else substep_loop)(rows)
        reset = reset_span(insns, sub) if sub is not None else None
        if sub is not None:
            print(f"sass:   substep loop {sub['start']:#07x}-{sub['end']:#07x}: {sub['n']} "
                  f"instructions a pass: fp32/int {sub['fp32/int']}, mufu {sub['mufu']}, "
                  f"other {sub['other']}")
        if reset is not None:
            print(f"sass:   reset block {reset['start']:#07x}-{reset['end']:#07x}: {reset['n']} "
                  f"instructions (fp32/int {reset['fp32/int']}, mufu {reset['mufu']}, other "
                  f"{reset['other']}), {reset['in_loop']} of them in the substep loop's count")
        result[short] = {"loops": rows, "substep": sub, "reset": reset, "insns": insns}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("lib", nargs="?", help="a built kernel library (default: build this "
                        "checkout's)")
    parser.add_argument("--out", help="where each kernel's SASS is written")
    parser.add_argument("--against", help="another kernel library: list the kernels whose "
                        "SASS is the same in both")
    parser.add_argument("--blocks", action="store_true", help="K2/K6's horizon loop by block "
                        "and K1's and K2/K6's occupancy, from a -lineinfo build (a card is "
                        "needed)")
    parser.add_argument("--src", help="the csrc directory that LIB was built from, for "
                        "--blocks (default: this checkout's)")
    args = parser.parse_args(argv)
    from . import _build

    lib = Path(args.lib) if args.lib else _build.build()
    ptxas = lib.with_suffix(".ptxas.txt")
    if ptxas.exists():
        for line in _build.ptxas_report(ptxas):
            if any(k in line for k in KERNELS + PPO_LOSS_KERNELS + WIDE_KERNELS):
                print(line)
    report(lib, Path(args.out) if args.out else None)
    if args.blocks:
        import tempfile

        src = Path(args.src) if args.src else _build.SRC_DIR
        with tempfile.TemporaryDirectory() as tmp:
            blocks_report(src, lib, Path(args.out) if args.out else Path(tmp))
    if args.against:
        groups = compare(lib, Path(args.against))
        for key, kernels in groups.items():
            print(f"sass: against {args.against}: {key} ({len(kernels)}): {'; '.join(kernels)}")
        for label, families in FLOAT32_FAMILIES.items():
            f32 = float32_instances(groups, families)
            print(f"sass: against {args.against}: float32 {label} instances the same instruction "
                  f"for instruction {len(f32['same'])}, differ {len(f32['differ'])} "
                  f"({'; '.join(f32['differ'])}), in one library only {len(f32['missing'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
