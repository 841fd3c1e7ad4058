#!/bin/bash
# APR-KITTI training launcher, the counterpart of scripts/train_apr_kitti.sh
# (reference FCGF_APR/scripts/train_apr_kitti.sh) for the PyTorch port.
# Env-var parameterized like the reference; defaults are the paper recipe.
# Runs on the CUDA card (pass --device cpu to run on the CPU).
set -e
cd "$(dirname "$0")/../.."

export KITTI_ROOT=${KITTI_ROOT:-./data/kitti}
export MODEL=${MODEL:-ResUNetFatBN}
export MODEL_N_OUT=${MODEL_N_OUT:-128}
export GENERATOR=${GENERATOR:-GenerativeMLP_98}
export OPTIMIZER=${OPTIMIZER:-SGD}
export LR=${LR:-1e-1}
export LOSS_RATIO=${LOSS_RATIO:-2e-3}
export MAX_EPOCH=${MAX_EPOCH:-200}
export BATCH_SIZE=${BATCH_SIZE:-4}
export VOXEL_SIZE=${VOXEL_SIZE:-0.3}
export HIT_RATIO_THRESH=${HIT_RATIO_THRESH:-0.3}
export CMPL_DIST=${CMPL_DIST:-10}
export CMPL_NUM=${CMPL_NUM:-3}
export GEN_RATIO=${GEN_RATIO:-4}
export REG_TYPE=${REG_TYPE:-L2}
export REG_STRENGTH=${REG_STRENGTH:-0.01}
export MIN_DIST=${MIN_DIST:-5}
export MAX_DIST=${MAX_DIST:-20}
export TIME=$(date +"%Y%m%d_%H%M%S")
export OUT_DIR=${OUT_DIR:-./outputs/apr_kitti_${MODEL}_${MODEL_N_OUT}_${LR}_${TIME}}

mkdir -p "$OUT_DIR"
echo "git sha: $(git rev-parse HEAD 2>/dev/null || echo unknown)" > "$OUT_DIR/env.txt"
hostname >> "$OUT_DIR/env.txt"

# Extra flags pass through.  A tuple field takes its own element type
# here (--nets self cross self), where the root train.py parses every
# tuple flag as ints (ROADMAP, "Faults of the reference": train.py:33-34).
python -m apr_torch.train \
  --trainer GenerativePairTrainer \
  --dataset PairComplementKittiDataset \
  --kitti_root "$KITTI_ROOT" \
  --model "$MODEL" \
  --model_n_out "$MODEL_N_OUT" \
  --conv1_kernel_size 5 \
  --generator_model "$GENERATOR" \
  --point_generation_ratio "$GEN_RATIO" \
  --optimizer "$OPTIMIZER" \
  --lr "$LR" \
  --loss_ratio "$LOSS_RATIO" \
  --regularization_type "$REG_TYPE" \
  --regularization_strength "$REG_STRENGTH" \
  --max_epoch "$MAX_EPOCH" \
  --batch_size "$BATCH_SIZE" \
  --voxel_size "$VOXEL_SIZE" \
  --hit_ratio_thresh "$HIT_RATIO_THRESH" \
  --complement_pair_dist "$CMPL_DIST" \
  --num_complement_one_side "$CMPL_NUM" \
  --pair_min_dist "$MIN_DIST" \
  --pair_max_dist "$MAX_DIST" \
  --use_old_pose false \
  --out_dir "$OUT_DIR" \
  "$@" 2>&1 | tee -a "$OUT_DIR/log_${TIME}.txt"
