"""Mean eval accuracy over each 10-epoch window of a quality run's log,
stage by stage, beside another run's.

Reads the ``run.log`` of ``scripts/quality_run.py`` (the JAX package) or of
``combat_tpu_torch.tools.quality_run`` (the port; a leading host-clock stamp
on each line is dropped): stage 1's test Clean, stage 2's eval Clean and
Bd, stage 3's test Clean and Bd.  An epoch printed twice (a resumed run
replays the epochs after its last save) counts once, at its last print.
Each row prints the window, each log's means and how many epochs the window
holds; a window that holds a learning-rate milestone (epochs 100 and 150,
``combat_tpu_torch/config.py``) is marked.

    python scripts/epoch_windows.py quality_logs/torch_r11/run.log quality_logs/r11/run.log
"""

import re
import sys
from typing import Dict, List

MILESTONES = (100, 150)  # the 0-based epoch at which each decay takes effect
_STAMP = re.compile(r"^\d+\.\d+ ")
_STAGE = re.compile(r"=== stage (\d)")
_CLEAN_EPOCH = re.compile(r"^Epoch (\d+): CE Loss: .*\| Clean Acc: ([\d.]+) - Best: [\d.]+(?: \| Bd Acc: ([\d.]+))?")
_ALT_EPOCH = re.compile(r"^Epoch (\d+): Clean Acc:")
_ALT_EVAL = re.compile(r"^\s+Eval: Clean Acc: ([\d.]+) - Best: [\d.]+ \| Bd Acc: ([\d.]+)")


def epochs(path: str) -> Dict[int, Dict[int, tuple]]:
    """{stage: {0-based epoch: (clean, bd or None)}} of the log at ``path``."""
    out: Dict[int, Dict[int, tuple]] = {}
    stage, pending = 0, None
    with open(path, errors="replace") as f:
        for raw in f:
            line = _STAMP.sub("", raw.rstrip("\n"))
            m = _STAGE.search(line)
            if m:
                stage, pending = int(m.group(1)), None
                out.setdefault(stage, {})
                continue
            if stage in (1, 3) and (m := _CLEAN_EPOCH.match(line)):
                bd = float(m.group(3)) if m.group(3) else None
                out[stage][int(m.group(1)) - 1] = (float(m.group(2)), bd)
            elif stage == 2 and (m := _ALT_EPOCH.match(line)):
                pending = int(m.group(1)) - 1
            elif stage == 2 and pending is not None and (m := _ALT_EVAL.match(line)):
                out[stage][pending] = (float(m.group(1)), float(m.group(2)))
                pending = None
    return out


def windows(per_epoch: Dict[int, tuple], width: int = 10) -> List[tuple]:
    """(first epoch, n, mean clean, mean bd or None) of each window."""
    rows = []
    for start in range(0, max(per_epoch, default=-1) + 1, width):
        got = [per_epoch[e] for e in range(start, start + width) if e in per_epoch]
        if got:
            bds = [b for _, b in got if b is not None]
            rows.append((start, len(got), sum(c for c, _ in got) / len(got), sum(bds) / len(bds) if bds else None))
    return rows


def _fmt(row) -> str:
    if row is None:
        return "—"
    _, n, clean, bd = row
    return f"{clean:.2f}" + (f" / {bd:.2f}" if bd is not None else "") + f" ({n})"


def main(paths: List[str]) -> None:
    logs = [epochs(p) for p in paths]
    for stage in sorted({s for log in logs for s in log}):
        tables = [{r[0]: r for r in windows(log.get(stage, {}))} for log in logs]
        print(f"stage {stage}: epochs | " + " | ".join(paths))
        for start in sorted({s for t in tables for s in t}):
            mark = " *" if any(start <= m < start + 10 for m in MILESTONES) else ""
            print(f"  {start + 1}-{start + 10}{mark} | " + " | ".join(_fmt(t.get(start)) for t in tables))


if __name__ == "__main__":
    main(sys.argv[1:])
