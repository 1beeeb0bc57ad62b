#!/usr/bin/env python3
"""ptxas's report on the port's CUDA kernels for two trees, side by side.

    python3 scripts/ptxas_compare.py OLD_TREE NEW_TREE [SOURCE ...]

Builds csrc/SOURCE.cu (default: fdtd3d and resident) of each tree's
meep_nl_tpu_torch with the port's nvcc flags and -Xptxas -v, all builds
started together, and prints for every kernel variant its registers,
spill stores and loads, stack frame and static shared memory in both
trees: "same" when they agree, both lines when they differ, the one line
of a variant only one tree has (a variant whose name carries one more
trailing template argument at 0 / false pairs with the old name without
it); then each build's wall seconds (nvcc is
single-threaded, so the concurrent builds barely slow each other on a
machine with a core for each).  Exits 1 when a variant both trees have
differs in registers or spills.  Needs nvcc (the CUDA toolkit), no card.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import subprocess
import sys
import tempfile
import time

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


#: (tree, source) -> the build's wall seconds
secs = {}


def report(tree: str, name: str, out_dir: str) -> dict:
    """{kernel: (registers, spill stores, spill loads, stack, smem)} of
    tree's csrc/<name>.cu."""
    csrc = os.path.join(tree, "meep_nl_tpu_torch", "csrc")
    nvcc = "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        nvcc = "nvcc"
    out = os.path.join(out_dir, f"{abs(hash(tree))}_{name}.so")
    t0 = time.perf_counter()
    res = subprocess.run([nvcc, *FLAGS, "-I", csrc, "-o", out,
                          os.path.join(csrc, f"{name}.cu")],
                         capture_output=True, text=True, timeout=1200)
    secs[(tree, name)] = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tree} {name}:\n{res.stderr}")
    kernels, cur = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            kernels[cur] = [0, 0, 0, 0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            kernels[cur][3] = int(m.group(1))
            kernels[cur][1], kernels[cur][2] = int(m.group(2)), \
                int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kernels[cur][0] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            kernels[cur][4] = int(s.group(1)) if s else 0
    return {k: tuple(v) for k, v in kernels.items()}


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__)
        return 2
    old, new = sys.argv[1], sys.argv[2]
    names = sys.argv[3:] or ["fdtd3d", "resident"]
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(2 * len(names)) as ex:
        jobs = {(t, n): ex.submit(report, t, n, tmp)
                for t in (old, new) for n in names}
        got = {k: f.result() for k, f in jobs.items()}
    bad = 0
    fields = "registers, spill stores, spill loads, stack, smem"
    for n in names:
        a, b = got[(old, n)], got[(new, n)]
        # a template argument appended with a default of 0 / false: the new
        # tree's variant at that default pairs with the old tree's name
        for k in [k for k in b if k not in a]:
            short = re.sub(r"E(Li0|Lb0)EEv", "EEv", k, count=1)
            if short != k and short in a and short not in b:
                b[short] = b.pop(k)
        print(f"== csrc/{n}.cu ({fields}): {len(a)} variants in "
              f"{old}, {len(b)} in {new}")
        for k in sorted(set(a) | set(b)):
            if k in a and k in b:
                if a[k] == b[k]:
                    print(f"same  {a[k]}  {k}")
                else:
                    print(f"old   {a[k]}  {k}\nnew   {b[k]}  {k}")
                    bad += a[k][:3] != b[k][:3]
            else:
                print(f"{'old' if k in a else 'new'} only  "
                      f"{a.get(k) or b.get(k)}  {k}")
    print(f"variants of both trees that differ in registers or spills: "
          f"{bad}")
    for n in names:
        print(f"csrc/{n}.cu built in {secs[(old, n)]:.1f} s ({old}), "
              f"{secs[(new, n)]:.1f} s ({new})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
