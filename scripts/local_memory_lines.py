#!/usr/bin/env python3
"""Where a kernel touches local memory: each LDL / STL by source line.

    python3 scripts/local_memory_lines.py foremast_tpu_torch/csrc/period.cu [more .cu files]

Needs the CUDA toolkit (nvcc and nvdisasm under /usr/local/cuda/bin), so it
runs on the machine with the card. Each source is compiled as the library
compiles it (sm_90a, -O3, -fmad=false) with -lineinfo into a cubin, which
`nvdisasm -g` prints with its source lines; every local-memory load and
store is counted under the kernel and the line it came from. A stack frame
in ptxas' report (kernels/build.py's build.log) says how much local memory
a kernel has; this says which arrays or spills it holds. The line numbers
are of the file nvdisasm names, the source or a header it includes.
"""
import collections
import re
import os
import subprocess
import sys
import tempfile

NV = "/usr/local/cuda/bin/"


def local_accesses(src):
    """{(kernel, file, line, op): count} for one source."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "kernel.cubin")
        subprocess.run([NV + "nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-fmad=false", "-lineinfo", "-cubin", "-o", cubin, src], check=True)
        text = subprocess.run([NV + "nvdisasm", "-g", "-c", cubin], capture_output=True,
                              text=True, check=True).stdout
    hits = collections.Counter()
    kernel, where = "?", ("?", 0)
    for ln in text.splitlines():
        if re.match(r"\s*\.section\s+\.text\.", ln):
            kernel = ln.split(".text.")[-1].split(",")[0].strip()
        m = re.search(r'//## File "([^"]+)", line (\d+)', ln)
        if m:
            where = (m.group(1).split("/")[-1], int(m.group(2)))
        op = re.search(r"\b(LDL|STL)\b", ln)
        if op:
            hits[(kernel, *where, op.group(1))] += 1
    return hits


def main():
    for src in sys.argv[1:]:
        print(f"{src}: local-memory loads and stores by source line", flush=True)
        for (kernel, f, line, op), n in sorted(local_accesses(src).items()):
            print(f"  {kernel[:48]} {f}:{line} {op} x{n}", flush=True)


if __name__ == "__main__":
    main()
