#!/usr/bin/env python3
"""SASS instructions of a kernel by source line, and the KS step's count.

    python3 scripts/sass_lines.py foremast_tpu_torch/csrc/pair_verdict.cu \
        --kernel pair_verdict_warp_kernelILi8E [--lines]

Needs the CUDA toolkit (nvcc and nvdisasm under /usr/local/cuda/bin), so it
runs on the machine with the card. The source is compiled as the library
compiles it (sm_90a, -O3, -fmad=false) with -lineinfo into a cubin, which
`nvdisasm -g` prints with its source lines; each instruction of the kernel
whose mangled name holds --kernel is counted under the line it came from
(inlined code under its own file and line). --lines prints every line's
count. Always printed: the instructions of the warp path's KS lattice step
(`warp_ks_exact_sf` in pair_common.cuh): those of one register's cells in
each of the step's two branches (the window kept, the window moved up),
i.e. a branch's instructions over its unrolled registers, IEEE division
included, and the step's own (the band's and the window's bounds, the loop),
with the one-register step's apart.
`ks_step_instructions` returns them to other scripts.
"""
import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile

NV = "/usr/local/cuda/bin/"
HERE = os.path.dirname(os.path.abspath(__file__))
COMMON = os.path.join(os.path.dirname(HERE), "foremast_tpu_torch", "csrc", "pair_common.cuh")


def line_counts(src, kernel):
    """{(file, line): instructions} of the kernel whose mangled name holds
    `kernel`, compiled from src."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "kernel.cubin")
        subprocess.run([NV + "nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-fmad=false", "-lineinfo", "-cubin", "-o", cubin, src], check=True)
        text = subprocess.run([NV + "nvdisasm", "-g", "-c", cubin], capture_output=True,
                              text=True, check=True).stdout
    counts = collections.Counter()
    inside, where = False, ("?", 0)
    for ln in text.splitlines():
        if re.match(r"\s*\.section\s+\.text\.", ln):
            inside = kernel in ln.split(".text.")[-1].split(",")[0]
        m = re.search(r'//## File "([^"]+)", line (\d+)', ln)
        if m:
            where = (os.path.basename(m.group(1)), int(m.group(2)))
        if inside and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", ln):
            counts[where] += 1
    return counts


def _ks_lines():
    """Line ranges of warp_ks_exact_sf's step: its own lines, the body of
    the one-register step, the kept and the moved window's register
    bodies, and the cell's own lines (ks_cell, ks_div) but the line of the
    IEEE division that only a quotient near the subnormal range takes."""
    with open(COMMON) as f:
        lines = f.read().splitlines()

    def find(text, after=0):
        return next(i + 1 for i in range(after, len(lines)) if text in lines[i])

    div = find("__device__ __forceinline__ float ks_div(")
    cell = find("__device__ __forceinline__ float ks_cell(")
    cell_end = find("}", cell + 1)
    fn = find("__device__ inline float warp_ks_exact_sf", cell_end)
    step = find("for (int d = 1; d <= N; ++d) {", fn)
    one = find("if (st.x >> 28 & 1) {", step)
    kept = find("} else if (!moved) {", one)
    moved = find("} else {", kept)
    end = find("// the last diagonal is cell n1 alone", moved) - 2
    rare = find("ks_div_ieee(num, fd)", cell)  # the call a rare cell takes: not on the path
    return {"step": list(range(step, one + 1)) + [end + 1],
            "one": list(range(one + 1, kept)), "kept": list(range(kept + 1, moved)),
            "moved": list(range(moved + 1, end)),
            "cell": [n for n in list(range(div + 1, div + 4)) + list(range(cell + 1, cell_end))
                     if n != rare]}


def ks_step_instructions(src, kernel, registers):
    """The KS step's SASS instructions in `kernel` (whose lattice window has
    `registers` registers, each wide branch unrolled over them): the step's
    own, the one-register step's, and a register of the kept and the moved
    window's, each with its cells' share (the cell's code is inlined once in
    the one-register step and once a register in each wide branch)."""
    counts = line_counts(src, kernel)
    got = {k: sum(counts[("pair_common.cuh", n)] for n in v) for k, v in _ks_lines().items()}
    cell = got["cell"] / (2 * registers + 1)
    return {"step": got["step"], "one_register": got["one"] + cell,
            "kept_register": got["kept"] / registers + cell,
            "moved_register": got["moved"] / registers + cell, "cell": cell,
            "registers": registers}


def _find(lines, text, after=0):
    return next(i + 1 for i in range(after, len(lines)) if text in lines[i])


def kruskal_row_instructions(src, kernel, M):
    """SASS instructions a row of kernel O's Kruskal-Wallis warp path runs
    in its register sort and in its lookups, in the instance `kernel` of M
    keys a lane: the compare-exchanges' code (bitonic_ce, common.cuh) over
    the network's in-lane exchanges (M/2 log M (log M + 1) / 2 in the runs
    up to M, M/2 log M after each of the 5 longer merges), the cross-lane
    step's (one shuffle and the exchange a key) over its 15 steps, and the
    binary search's step over its log2(32 M) steps for each of the M keys
    a lane. The sort's in-lane exchanges are one body inlined at two
    places (the first runs, and once inside the merges' loop), so their
    instructions are split by the exchanges each place holds."""
    counts = line_counts(src, kernel)
    common = os.path.join(os.path.dirname(os.path.abspath(src)), "common.cuh")
    with open(common) as f:
        lc = f.read().splitlines()
    with open(src) as f:
        lr = f.read().splitlines()
    ce = _find(lc, "void bitonic_ce(")
    ce_end = _find(lc, "}", _find(lc, "} else {", ce))  # the 64-bit branch's end
    cross = _find(lc, "const K o = __shfl_xor_sync(kFullWarp, k[r], lm);")
    search = _find(lr, "pos[u] += sorted[pos[u] + step - 1]")
    log_m = M.bit_length() - 1
    first, after = M // 2 * log_m * (log_m + 1) // 2, M // 2 * log_m
    ce_ins = sum(counts[("common.cuh", n)] for n in range(ce + 1, ce_end))
    x_ins = sum(counts[("common.cuh", n)] for n in range(cross + 1, cross + 5)) + M
    s_ins = counts[(os.path.basename(src), search)]
    unroll = min(M, 8)
    sort = ce_ins / max(first + after, 1) * (first + 5 * after) + 15 * x_ins
    lookups = s_ins * (5 + log_m) * (M // unroll)
    return {"sort": sort, "lookups": lookups, "compare_exchange": ce_ins / max(first + after, 1),
            "cross_step": x_ins, "search_step": s_ins}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src")
    p.add_argument("--kernel", required=True, help="a part of the kernel's mangled name")
    p.add_argument("--registers", type=int, default=5,
                   help="the KS window's registers in that instance (M / 2 + 1)")
    p.add_argument("--lines", action="store_true", help="print every line's count")
    opt = p.parse_args()
    if opt.lines:
        for (f, n), c in sorted(line_counts(opt.src, opt.kernel).items()):
            print(f"  {f}:{n} {c}", flush=True)
    print(ks_step_instructions(opt.src, opt.kernel, opt.registers), flush=True)


if __name__ == "__main__":
    sys.exit(main())
