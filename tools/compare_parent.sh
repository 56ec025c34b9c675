#!/bin/bash
# Run chip_smoke.py of a parent tree and of this tree in turns on one GPU
# (parent, change, change, parent), so that both are timed on the same
# card in one session.
#
#   tools/compare_parent.sh PARENT_DIR OUT_DIR [ARGS...]
#
# PARENT_DIR holds `git archive <parent> chip_smoke.py turborc_tpu_torch`
# unpacked; the corpora are linked in from this tree.  ARGS go to this
# tree's chip_smoke.py (for example `--before <parent>`).  Each run's
# output goes to OUT_DIR/cmp_<who>.log; the script prints each run's exit
# code and seconds and fails if any run failed.
set -u
root=$(cd "$(dirname "$0")/.." && pwd)
parent=$(cd "$1" && pwd)
mkdir -p "$2"
out=$(cd "$2" && pwd)
shift 2
data=turborc_tpu/bench/_data
if [ ! -e "$parent/$data" ]; then
  mkdir -p "$(dirname "$parent/$data")"
  ln -s "$root/$data" "$parent/$data"
fi
fail=0
for who in parent change change2 parent2; do
  case $who in
    parent*) dir=$parent; args=() ;;
    *) dir=$root; args=("$@") ;;
  esac
  t0=$(date +%s)
  (cd "$dir" && python3 chip_smoke.py "${args[@]}" \
     > "$out/cmp_$who.log" 2>&1)
  rc=$?
  echo "$who rc=$rc $(( $(date +%s) - t0 )) s"
  [ $rc -eq 0 ] || fail=1
done
exit $fail
