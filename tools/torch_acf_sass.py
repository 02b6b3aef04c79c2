#!/usr/bin/env python3
"""Print the instruction mix of kernel A's inner loop, as compiled for sm_90a.

    python3 tools/torch_acf_sass.py

Builds the port's kernel library (``spinrelax_tpu_torch/_build.py``),
disassembles it with ``cuobjdump -sass`` and prints, for
``acf_lag_sums_kernel``, the opcodes between its first and last FP32 FMA
(the unrolled TBLK-frame body of the lag walk): their count, their count
per frame, and the share that is FP32 (FFMA, FMUL).  Needs the CUDA
toolkit (nvcc and cuobjdump), not a GPU.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OPCODE = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]+)")


def main() -> int:
    sys.path.insert(0, str(REPO))
    from spinrelax_tpu_torch import _build
    from spinrelax_tpu_torch.ops import cuda_acf

    lib = _build.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    fn = next(s for s in sass.split("Function : ") if "acf_lag_sums_kernel" in s[:300])
    ops = [m.group(1) for m in map(OPCODE.search, fn.splitlines()) if m]
    fma = [i for i, op in enumerate(ops) if op == "FFMA"]
    body = collections.Counter(ops[fma[0] : fma[-1] + 1])
    n = sum(body.values())
    fp32 = body["FFMA"] + body["FMUL"]
    print(f"acf_lag_sums_kernel: {len(ops)} instructions; inner loop body {n} "
          f"for {cuda_acf.TBLK} frames = {n / cuda_acf.TBLK:.2f} per frame "
          f"({cuda_acf.LAGS} lags), FP32 {fp32} = {fp32 / n:.1%}")
    print("  " + ", ".join(f"{op} {c}" for op, c in body.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
