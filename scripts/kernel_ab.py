"""The trigger kernels of two checkouts timed on one card, in turns.

    python scripts/kernel_ab.py PARENT CHANGE

PARENT and CHANGE are checkouts of the repository (``git archive <commit> |
tar -x -C <dir>``).  Each run is phase 2 of the checkout's own
``chip_smoke.py`` (``compare_kernels``: K1-K3 against their plain versions,
then timed at 32 and 64 px and, through the tiled kernels, at 224 px with
their traced split by part) in a process of its own, in the order parent,
change, change, parent, with TF32 off.  A checkout builds its kernels into
its own ``build/``.  Prints the card's name and power limit, the registers
ptxas gave each tiled kernel, and each run's 224 px lines; writes each run's
rows and output to ``chiprun_out/kernel_ab/<n>_<parent|change>_<checkout>.json``
and ``.log``.
Needs a CUDA card and ``nvcc``; exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys

OUT = "chiprun_out/kernel_ab"


def _run(checkout: str, out: str, log: str) -> None:
    """One run, in a process of its own: the checkout's kernels and its
    chip_smoke.py, everything it prints sent to ``log``."""
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from combat_tpu_torch.ops import trigger_kernels as tk

    tk.build()
    lines = tk.BUILD_LOG.splitlines()
    for i, line in enumerate(lines):
        if "entry function '_ZN5tiled" in line:
            used = next((x for x in lines[i + 1:i + 4] if "registers" in x), "")
            print(f"  {line.split('entry function ')[1].split(' ')[0]}: {used.split(': ', 1)[-1]}", flush=True)
    import chip_smoke

    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != checkout:
        raise SystemExit(f"chip_smoke.py was not imported from {checkout}")
    rows = chip_smoke.compare_kernels()
    with open(out, "w") as f:
        json.dump(rows, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("parent")
    ap.add_argument("change")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    spawn = multiprocessing.get_context("spawn")
    rc = 0
    for n, name in enumerate(("parent", "change", "change", "parent"), 1):
        checkout = os.path.abspath(getattr(args, name))
        stem = os.path.abspath(os.path.join(OUT, f"{n}_{name}_{os.path.basename(checkout)}"))
        print(f"=== run {n}: {name} ({checkout})", flush=True)
        proc = spawn.Process(target=_run, args=(checkout, stem + ".json", stem + ".log"))
        proc.start()
        proc.join()
        with open(stem + ".log") as f:
            out = f.read()
        for line in out.splitlines():
            if line.startswith("  _ZN5tiled") or "at 224 px" in line or " pass: " in line:
                print(line, flush=True)
        if proc.exitcode != 0:
            print(f"run {n} ({name}) failed with {proc.exitcode}: {out[-2000:]}", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
