#!/usr/bin/env bash
# A/B of two forms of csrc/flash_attention.cu on one card, in one call.
#
#     bash tools/flash_ab.sh OTHER
#
# OTHER is another tree with src/, tools/ and chip_smoke.py (a parent
# commit unpacked by `git archive` into build/, or this tree with one
# change). `tools/kernel_probe.py --flash` (flash_attention alone, at the
# main path's and the backbone zoo's shapes) runs from OTHER, this tree,
# this tree and OTHER, in that order, each process's JSON lines to
# chiprun_out/flash_ab/<n>_<which>.log beside the card's name and limit;
# each tree's first run builds its kernel into its own build/, alone on
# the machine, and logs the build's seconds.
set -euo pipefail
other=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
out="$here/chiprun_out/flash_ab"
mkdir -p "$out"
n=0
for which in other this this other; do
  n=$((n + 1))
  tree=$other
  [ "$which" = this ] && tree=$here
  (cd "$tree" && python3 tools/kernel_probe.py --flash) > "$out/${n}_${which}.log"
  echo "run $n ($which): $(grep -c '"kernel"' "$out/${n}_${which}.log") rows;" \
    "$(grep '^build:' "$out/${n}_${which}.log")"
done
