"""Opcode histogram of each kernel in the port's built library, from
``cuobjdump -sass`` (CUDA toolkit; run where nvcc is, after a build).

    python3 scripts/port_sass_histogram.py [kernel-name-substring ...]

Builds the library if needed (plonky2_tpu_torch/kernels.py:build), then
prints, per kernel whose mangled name contains one of the substrings (all
kernels when none is given), its instruction count and the count of each
opcode (modifiers kept, predicates dropped), most frequent first.  The
counts are static: instructions in the code, not executed.
"""
from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from plonky2_tpu_torch import kernels  # noqa: E402

OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                    r"([A-Z][A-Z0-9_.]*)")


def histograms(path: str) -> dict:
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()),
                             "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in dump.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        out[name] = collections.Counter(OPCODE.findall(block))
    return out


def main() -> int:
    wanted = sys.argv[1:]
    for name, hist in histograms(kernels.build()["path"]).items():
        if wanted and not any(w in name for w in wanted):
            continue
        total = sum(hist.values())
        print(f"{name}: {total} instructions")
        print("  " + ", ".join(f"{op} {n}" for op, n in hist.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
