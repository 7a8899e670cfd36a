#!/usr/bin/env bash
# One job of a `combat_tpu_torch.tools.quality_run` split into jobs, each on a
# machine of its own: a job restores the checkpoints an earlier job left, runs
# the stages `Q_STAGES` picks, and leaves what the next job reads.
#
#   PREFIX=torch_r11 TAG=a Q_STAGES=1 Q_EPOCHS_CLEAN=60 OUT=temps/out/torch_r11 \
#       bash scripts/torch_quality_call.sh
#
# - Restores `temps/$PREFIX/checkpoints/` (git-ignored, copied with the tree)
#   into `./checkpoints/`.
# - Runs the stages under `timeout $STAGE_TIMEOUT` (seconds; none if unset,
#   the run then stops at its own `--n_iters`).  A stage stopped there keeps
#   its last best-gated checkpoint: a checkpoint is written to a temporary
#   name and renamed, so a stop never leaves half of one.  Every other
#   `quality_run` knob (`Q_EPOCHS_*`, `Q_EXTRA`) passes through.
# - Stamps each output line with the host clock (seconds since the epoch)
#   into `$OUT/run_$TAG.log` (`OUT`: `temps/out/$PREFIX` unless set), copies
#   every run's JSONL to `$OUT/<run>/`, and writes beside them the payloads
#   the next stage loads and nothing else (`checkpoints/<run>/...`): the
#   clean classifier's `netC` (the generator's frozen clean model) and the
#   generator's `netG` (the victim's and the eval's trigger), of the stages
#   this job ran (`KEEP`, a comma-separated list of `clean_cls` and `atk`,
#   overrides it; `KEEP=` writes none).  Move them to
#   `temps/$PREFIX/checkpoints/` for the next job.
set -uo pipefail
: "${PREFIX:?set PREFIX}" "${TAG:?set TAG}"
OUT=${OUT:-temps/out/$PREFIX}
mkdir -p "$OUT" checkpoints
if [ -d "temps/$PREFIX/checkpoints" ]; then
    cp -r "temps/$PREFIX/checkpoints/." checkpoints/
fi
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$OUT/run_$TAG.log"
stamp() { python3 -u -c 'import sys, time
for line in sys.stdin:
    print(f"{time.time():.3f} {line}", end="", flush=True)'; }
if [ -n "${STAGE_TIMEOUT:-}" ]; then
    Q_PREFIX=$PREFIX timeout --signal=TERM "$STAGE_TIMEOUT" python3 -u -m combat_tpu_torch.tools.quality_run 2>&1 \
        | stamp | tee -a "$OUT/run_$TAG.log"
else
    Q_PREFIX=$PREFIX python3 -u -m combat_tpu_torch.tools.quality_run 2>&1 | stamp | tee -a "$OUT/run_$TAG.log"
fi
rc=${PIPESTATUS[0]}
echo "quality_run exit $rc" | stamp | tee -a "$OUT/run_$TAG.log"
for log in checkpoints/"$PREFIX"_*/*/log_dir/*.jsonl; do
    [ -e "$log" ] || continue
    run=$(basename "$(dirname "$(dirname "$(dirname "$log")")")")
    mkdir -p "$OUT/$run" && cp "$log" "$OUT/$run/"
done
ran=",${Q_STAGES:-1,2,3,4},"
default_keep=$( [[ $ran == *,1,* ]] && printf 'clean_cls,'; [[ $ran == *,2,* ]] && printf 'atk' )
python3 - "$PREFIX" "$OUT" "${KEEP-$default_keep}" <<'EOF'
import glob, os, sys

import torch

prefix, out, keep = sys.argv[1:]
for name, run, key in (("clean_cls", f"{prefix}_clean_cls", "netC"), ("atk", f"{prefix}_atk_clean", "netG")):
    if name not in keep.split(","):
        continue
    for path in glob.glob(f"checkpoints/{run}/*/*.pt"):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        slim = {key: payload[key], "epoch_current": payload["epoch_current"]}
        dest = os.path.join(out, path)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        torch.save(slim, dest)
        print(f"kept {key} of {path} (epoch {payload['epoch_current']}) in {dest}")
EOF
exit "$rc"
