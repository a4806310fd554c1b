"""The instruction mix of each kernel's innermost loop, from the machine
code of a built library, as one JSON line.

    python -m voxelized_geometry_tools_tpu_torch.kernels.sass_mix NAME

builds ``csrc/NAME.cu`` if needed, disassembles it with the CUDA toolkit's
``cuobjdump -sass`` and prints ``SASS_MIX {...}``: for each kernel, the
largest straight-line block of its machine code (between two branches:
the fully unrolled body of its inner loop, for the envelope kernels),
that block's instructions by opcode, and how many of its FADDs reuse an
operand from the register reuse cache. Needs the toolkit, not a card.
"""

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

from voxelized_geometry_tools_tpu_torch.kernels import build

_INSTRUCTION = re.compile(
    r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)")


def loop_mix(sass: str) -> dict:
    """``{kernel: {"instructions", "fadd_reuse", "opcodes"}}`` of the
    largest straight-line block of each function in ``sass``."""
    mix = {}
    for function in re.split(r"\n\s+Function : ", sass)[1:]:
        name = function.split("\n", 1)[0].strip()
        blocks, block = [], []
        for line in function.splitlines():
            m = _INSTRUCTION.match(line)
            if not m:
                continue
            block.append((m.group(1), line))
            if m.group(1) in ("BRA", "EXIT"):
                blocks.append(block)
                block = []
        if not blocks:
            continue
        body = max(blocks, key=len)
        mix[name] = {
            "instructions": len(body),
            "fadd_reuse": sum(op == "FADD" and ".reuse" in line
                              for op, line in body),
            "opcodes": dict(collections.Counter(op for op, _ in body)
                            .most_common())}
    return mix


def main(name: str) -> dict:
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build(name))],
                          capture_output=True, text=True, check=True).stdout
    mix = loop_mix(sass)
    print("SASS_MIX " + json.dumps({"library": name, "kernels": mix}),
          flush=True)
    return mix


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "edt_envelope")
