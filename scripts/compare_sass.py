#!/usr/bin/env python3
"""Compare the SASS of two builds of a kernel library, kernel by kernel.

    python3 scripts/compare_sass.py NEW.so OLD.so [--match SUBSTRING]

Disassembles both shared libraries with ``cuobjdump -sass`` (the CUDA
toolkit's, on a machine with one) and compares each kernel the old build
has, instruction by instruction, with the addresses and comments dropped
and every kernel-parameter operand (``c[0x0][...]``) read as one: a
change to the parameter block's size moves those offsets without changing
the code.  ``--match`` keeps the kernels whose mangled name contains the
substring (``Li0EEEvNS_4ArgsE``: the chunk kernel's unarmed ones).  Prints
one JSON object: the kernels compared, how many are the same, and for
each that differs its instruction counts and first differing
instructions.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")
COMMENT = re.compile(r"/\*.*?\*/")
PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def kernels(path: str) -> dict:
    """Kernel name -> its normalized instructions."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    found, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            found[name] = []
        elif name and ADDRESS.search(line):
            ins = COMMENT.sub("", ADDRESS.sub("", line))
            found[name].append(PARAM.sub("c[0x0][P]", ins).strip())
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("new")
    ap.add_argument("old")
    ap.add_argument("--match", default="")
    args = ap.parse_args(argv)
    new, old = kernels(args.new), kernels(args.old)
    names = [n for n in old if args.match in n]
    differ = {}
    for n in names:
        a, b = new.get(n, []), old[n]
        if a != b:
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            differ[n] = dict(instructions=[len(a), len(b)], first=i,
                             new=a[i:i + 3], old=b[i:i + 3])
    print(json.dumps(dict(compared=len(names),
                          same=len(names) - len(differ), differ=differ)))
    return 0 if not differ else 1


if __name__ == "__main__":
    raise SystemExit(main())
