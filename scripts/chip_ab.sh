#!/usr/bin/env bash
# Same-call A/B of chip_smoke.py against another commit, on one card.
#
#   git archive <commit> | tar -x -C build/ --one-top-level=parent
#   scripts/chip_ab.sh build/parent [OUT]
#
# Runs the other tree's chip_smoke.py, this tree's, this tree's again and
# the other's again (each builds its own kernels), keeps each full output
# in OUT/<run>.log (default build/ab), prints each run's [build], [occupancy],
# [times], [narrow vs wide] and [split] lines and its kernel JSON line, and
# times K1 and K2 at the wide kernel's shapes with that tree's package
# (scripts/wide_shapes.py: the 40-tag served shape is not in older trees'
# chip_smoke.py), then the
# narrow and wide kernels' SASS counts of both builds (scripts/sass_counts.py;
# HMMA shows the wide kernel's tensor-core path).
# Exits non-zero if any run failed.
set -u
other=${1:?usage: scripts/chip_ab.sh DIR [OUT]}
here=$(pwd)
out=$here/${2:-build/ab}
mkdir -p "$out"
status=0

run() {
  local label=$1 dir=$2
  (cd "$dir" && python3 chip_smoke.py) >"$out/$label.log" 2>&1
  local rc=$?
  echo "== $label: rc $rc"
  grep -E '^\[(build|occupancy|times|narrow vs wide|split)\]|^\{"kernels"' "$out/$label.log"
  python3 "$here/scripts/wide_shapes.py" "$dir" 2>&1 | tee -a "$out/$label.log" | grep -E '^\[wide shapes\]|rror' || status=1
  if [ $rc -ne 0 ]; then
    tail -n 30 "$out/$label.log"
    status=1
  fi
}

run parent-1 "$other"
run change-1 "$here"
run change-2 "$here"
run parent-2 "$other"
python3 scripts/sass_counts.py build/gordo_tpu_torch/fleet_dense-*.so "$other"/build/gordo_tpu_torch/fleet_dense-*.so \
  --kernel fleet_dense_narrow_kernel --kernel fleet_dense_wide_kernel || status=1
exit $status
