#!/usr/bin/env python3
"""What the 16-bit flash kernels' loops are made of, from their SASS.

    python3 tools/flash_sass.py [--lib SO] [NAME_PART ...]

On a machine with the CUDA toolkit: builds the kernel library
(`_build.library()`), or takes the shared library SO (another tree's
flash kernels, such as the `libold.so` that tools/flash_parent_ab.py
builds), disassembles it with `cuobjdump -sass`, and for each
bf16 flash kernel (`flash_fwd_wgmma`, `flash_dq_wgmma`, `flash_dkv_wgmma`)
whose mangled name holds every NAME_PART (default: the UNet's narrow d80
body, `Li128ELi80E`, and the width-128 FIT body, `Li128ELi128ELb0ELb1E`)
prints one JSON line: the kernel's instructions in all, and for its main
loop (the longest backward branch whose source is not in the out-of-line
barrier-wait blocks at the function's end) the instructions it spans and
the count of each opcode in it.  A per-score test in an unrolled loop
shows as one BSSY / BSYNC pair (and a BRA) a score; MUFU.EX2 counts the
exps, HGMMA the wgmma k-steps.
"""
from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

KERNELS = ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma")
DEFAULT = (("Li128ELi80E",), ("Li128ELi128ELb0ELb1E",))


def _instructions(body):
    """[(address, opcode, text)] of one function's SASS listing."""
    out = []
    for m in re.finditer(r"/\*([0-9a-f]{4,6})\*/\s+([^;]*);", body):
        text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
        out.append((int(m.group(1), 16), text.split()[0], text))
    return out


def main_loop(ins):
    """(first, last) address of the longest backward branch whose source
    lies before the function's last tenth (where the compiler puts the
    retry blocks of barrier waits), or None."""
    end = ins[-1][0]
    best = None
    for addr, op, text in ins:
        m = re.search(r"0x([0-9a-f]+)", text) if op == "BRA" else None
        if not m or addr > 0.9 * end:
            continue
        tgt = int(m.group(1), 16)
        if tgt < addr and (best is None or addr - tgt > best[1] - best[0]):
            best = (tgt, addr)
    return best


def main(parts):
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch.ops import _build
    if parts[:1] == ["--lib"]:
        lib, parts = parts[1], parts[2:]
    else:
        lib = str(_build.build())
    cuobj = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobj, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    wanted = [tuple(parts)] if parts else DEFAULT
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if (not any(k in name for k in KERNELS)
                or "13__nv_bfloat16" not in name
                or not any(all(p in name for p in w) for w in wanted)):
            continue
        ins = _instructions(body)
        loop = main_loop(ins)
        rec = dict(lib=os.path.basename(lib), kernel=name,
                   instructions=len(ins))
        if loop:
            inside = [op for a, op, _ in ins if loop[0] <= a <= loop[1]]
            rec.update(loop_instructions=len(inside),
                       loop_ops=dict(collections.Counter(inside)
                                     .most_common()))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
