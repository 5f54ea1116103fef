#!/usr/bin/env python3
"""
Static SASS instruction counts of a kernel in built CUDA libraries.

    python3 scripts/sass_counts.py LIB.so [LIB.so ...] [--kernel NAME]

Disassembles each library with ``cuobjdump -sass`` (from ``PATH`` or
``$CUDA_HOME/bin``, default ``/usr/local/cuda``) and prints, for every
function whose mangled name contains ``NAME`` (default
``fleet_dense_narrow_kernel``; give ``--kernel`` more than once for
several), its instruction count, the count of each opcode, most frequent
first, and the counts of the opcode families that show the tensor-core
path: ``HMMA`` (``mma.sync``) and the conversions ``F2FP``, ``F2F`` and
``FRND`` (where ``cvt.rna.tf32.f32`` lands). The counts are of the code,
not of a run: a fully unrolled loop counts every width it can take.
"""

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
#: opcode families (the opcode before its first ".") counted apart
FAMILIES = ("HMMA", "F2FP", "F2F", "FRND")
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")


def opcode_counts(sass: str, kernel: str):
    """``{function: Counter(opcode)}`` for the functions naming ``kernel``."""
    counts, current = {}, None
    for line in sass.splitlines():
        header = FUNCTION.match(line)
        if header:
            current = header.group(1) if kernel in header.group(1) else None
            if current:
                counts[current] = collections.Counter()
            continue
        if current:
            op = INSTRUCTION.search(line)
            if op:
                counts[current][op.group(1)] += 1
    return counts


def family_counts(ops) -> dict:
    """``{family: count}`` over ``FAMILIES`` of one function's opcode counts."""
    counts = dict.fromkeys(FAMILIES, 0)
    for op, n in ops.items():
        family = op.split(".")[0]
        if family in counts:
            counts[family] += n
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("libraries", nargs="+")
    parser.add_argument("--kernel", action="append")
    args = parser.parse_args(argv)
    for path in args.libraries:
        sass = subprocess.run([cuobjdump(), "-sass", path], capture_output=True, text=True, check=True).stdout
        for kernel in args.kernel or ["fleet_dense_narrow_kernel"]:
            counts = opcode_counts(sass, kernel)
            if not counts:
                print(f"[sass] {path}: no function naming {kernel}")
                return 1
            for function, ops in counts.items():
                top = ", ".join(f"{op} {n}" for op, n in ops.most_common(24))
                focus = ", ".join(f"{family} {n}" for family, n in family_counts(ops).items())
                print(f"[sass] {os.path.basename(path)} {function}: {sum(ops.values())} instructions; "
                      f"families {focus}; {top}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
