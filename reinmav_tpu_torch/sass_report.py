"""The SASS of the closed-loop kernels K5, K10 and K8/K9: each loop of each
kernel with its static instruction count by pipe, and the substep loop
(K8/K9: the horizon loop, with its reset block counted apart).

Run on a machine with the CUDA toolkit, from the root of a checkout::

    python3 -m reinmav_tpu_torch.sass_report [LIB] [--out DIR] [--against OTHER_LIB]

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
(nested loops included), counted by pipe beside the loop.  A static
count: a block that a branch skips on most substeps (a slow path, the
reset) is counted as if it ran.  ``chip_smoke.py`` calls :func:`report` on the
library it built.  With ``--against``, it also lists which kernels of
the two libraries have the same SASS, instruction for instruction (such a
kernel gives the same bits on every input), and which differ.
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
           "closed_loop_kernel")
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
    with a prefix of its own build)."""

    def by_name(path: Path) -> dict:
        funcs = parse_functions(_disassemble(path))
        return {short_name(pretty): funcs[m] for m, pretty in zip(funcs, demangle(list(funcs)))}

    a, b = by_name(lib), by_name(other)
    group = {"same": [], "differ": [], "only_lib": [], "only_other": []}
    for n in sorted(set(a) | set(b)):
        key = ("only_other" if n not in a else "only_lib" if n not in b else
               "same" if a[n] == b[n] else "differ")
        group[key].append(n)
    return group


def report(lib: Path, out_dir: Path | None = None) -> dict[str, dict]:
    """Disassemble ``lib`` with the ``cuobjdump`` beside nvcc; print and
    return each K5/K10/K8/K9 kernel's loops, its substep loop's counts and
    that loop's reset block (:func:`reset_span`, None where it has none),
    keyed by the demangled name.  With ``out_dir``, each kernel's SASS is
    written there."""
    funcs = parse_functions(_disassemble(lib))
    names = list(funcs)
    result = {}
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    for mangled, pretty in zip(names, demangle(names)):
        short = short_name(pretty)
        if not any(k in short for k in KERNELS):
            continue
        insns = funcs[mangled]
        rows = loops(insns)
        where = ""
        if out_dir is not None:
            path = out_dir / (re.sub(r"[^A-Za-z0-9_]+", "_", short).strip("_") + ".sass")
            path.write_text("\n".join(f"/*{a:05x}*/ {op} {args}" for a, op, args in insns) + "\n")
            where = f" ({path})"
        print(f"sass: {short}: {len(insns)} instructions, {len(rows)} loops{where}")
        for r in sorted(rows, key=lambda r: r["start"]):
            print(f"sass:   loop {r['start']:#07x}-{r['end']:#07x}: {r['n']} instructions "
                  f"(fp32/int {r['fp32/int']}, mufu {r['mufu']}, other {r['other']}; "
                  f"{len(r['inner'])} nested loops excluded; {' '.join(r['mufu_ops'])})")
        sub = substep_loop(rows)
        reset = reset_span(insns, sub) if sub is not None else None
        if sub is not None:
            print(f"sass:   substep loop {sub['start']:#07x}-{sub['end']:#07x}: {sub['n']} "
                  f"instructions a pass: fp32/int {sub['fp32/int']}, mufu {sub['mufu']}, "
                  f"other {sub['other']}")
        if reset is not None:
            print(f"sass:   reset block {reset['start']:#07x}-{reset['end']:#07x}: {reset['n']} "
                  f"instructions (fp32/int {reset['fp32/int']}, mufu {reset['mufu']}, other "
                  f"{reset['other']}), {reset['in_loop']} of them in the substep loop's count")
        result[short] = {"loops": rows, "substep": sub, "reset": reset}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("lib", nargs="?", help="a built kernel library (default: build this "
                        "checkout's)")
    parser.add_argument("--out", help="where each kernel's SASS is written")
    parser.add_argument("--against", help="another kernel library: list the kernels whose "
                        "SASS is the same in both")
    args = parser.parse_args(argv)
    from . import _build

    lib = Path(args.lib) if args.lib else _build.build()
    ptxas = lib.with_suffix(".ptxas.txt")
    if ptxas.exists():
        for line in _build.ptxas_report(ptxas):
            if any(k in line for k in KERNELS):
                print(line)
    report(lib, Path(args.out) if args.out else None)
    if args.against:
        for key, kernels in compare(lib, Path(args.against)).items():
            print(f"sass: against {args.against}: {key} ({len(kernels)}): {'; '.join(kernels)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
