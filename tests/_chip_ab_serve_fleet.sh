# Parent/tree A/B of chip_smoke.py's [serve_fleet] phase on one card, one
# process a run. Unpack both trees first, from a checkout's root:
#   mkdir -p _archive/parent _archive/final
#   git archive <parent commit> | tar -x -C _archive/parent
#   git archive $(git write-tree) | tar -x -C _archive/final
# then, on a machine with one H100 (AB_ORDER defaults to parent final final parent):
#   bash tests/_chip_ab_serve_fleet.sh
#   AB_ORDER="final parent parent final" bash tests/_chip_ab_serve_fleet.sh
# Prints each run's phase lines and its total ("AB <side> <s> s"); logs go to
# chiprun_out/ab_<side>.log.
mkdir -p chiprun_out
for side in ${AB_ORDER:-parent final final parent}; do
  (cd _archive/$side && PYTHONPATH=. python3 -c '
import sys, time, torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t = time.perf_counter()
cs.serve_fleet_phase(cs.card_line())
print("AB", sys.argv[1], round(time.perf_counter() - t, 1), "s")
' "$side") > chiprun_out/ab_$side.log 2>&1
  rc=$?
  grep -E "^AB|^  [a-z_ ]+ in [0-9.]+ s$" chiprun_out/ab_$side.log | tail -8
  [ $rc -ne 0 ] && { tail -30 chiprun_out/ab_$side.log; exit $rc; }
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
