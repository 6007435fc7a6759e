#!/bin/bash
# The 6-stage GA3C self-play curriculum of scripts/train_curriculum.sh on the
# PyTorch port, through scripts/train_ppo_torch.py on the CUDA card: the same
# stages (2 -> 4 -> 4 -> 6 -> 10 agents at E = 256 for 600 iterations, then
# 10 agents at E = 512 for 900), horizon 64, shaping 0.1, the suite-matched
# pool (side 4.0), each stage warm-started from the previous stage's net with
# a fresh optimizer (--init-params) and exported in the JAX package's layout
# (--export-params), so scripts/eval_trained_net_torch.py and
# scripts/eval_trained_net.py both score it.  A stage whose file exists is
# skipped.  Usage: scripts/train_curriculum_torch.sh [OUT_DIR] [SEED]
set -e
cd "$( dirname "${BASH_SOURCE[0]}" )/.."
D=${1:-results/torch_curriculum}
SEED=${2:-0}
mkdir -p "$D"
COMMON="--arch ga3c --self-play --horizon 64 --shaping 0.1 --pool-side 4.0 --seed $SEED"
T0=$(date +%s)
#         stage agents envs iters init
for spec in "1 2 256 600 " \
            "2 4 256 600 $D/stage1_2ag.npz" \
            "3 4 256 600 $D/stage2_4ag.npz" \
            "4 6 256 600 $D/stage3_4ag.npz" \
            "5 10 256 600 $D/stage4_6ag.npz" \
            "6 10 512 900 $D/stage5_10ag.npz"; do
  set -- $spec; N=$1; A=$2; E=$3; I=$4; INIT=$5
  if [ -f "$D/stage${N}_${A}ag.npz" ]; then echo "STAGE $N done, skip"; continue; fi
  S0=$(date +%s)
  if [ -n "$INIT" ]; then IP="--init-params $INIT"; else IP=""; fi
  python scripts/train_ppo_torch.py $COMMON --agents $A --envs $E --iters $I $IP \
      --export-params "$D/stage${N}_${A}ag.npz"
  echo "STAGE $N (${A}ag) wall: $(( $(date +%s) - S0 ))s"
done
echo "TOTAL curriculum wall: $(( $(date +%s) - T0 ))s"
