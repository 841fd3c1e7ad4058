#!/bin/bash
# FCGF baseline (no generative branch) on nuScenes, the counterpart of
# scripts/train_fcgf_nuscenes.sh (reference FCGF_APR/scripts/
# train_fcgf_nuscenes.sh: HardestContrastive, ResUNetBN2C, n_out 128, SGD
# lr 1e-1, 200 epochs, voxel 0.3) for the PyTorch port, on the CUDA card.
set -e
cd "$(dirname "$0")/../.."
export OUT_DIR=${OUT_DIR:-./outputs/fcgf_nuscenes_$(date +%Y%m%d_%H%M%S)}
# extra flags pass through; tuple flags take their field's element type
# (ROADMAP, "Faults of the reference": train.py:33-34)
python -m apr_torch.train \
  --trainer "${TRAINER:-HardestContrastiveLossTrainer}" \
  --dataset PairComplementNuscenesDataset \
  --kitti_root "${NUSC_ROOT:-./data/nuscenes}" \
  --model "${MODEL:-ResUNetBN2C}" --model_n_out "${MODEL_N_OUT:-128}" \
  --conv1_kernel_size 5 \
  --optimizer SGD --lr "${LR:-1e-1}" --weight_decay "${WEIGHT_DECAY:-1e-4}" \
  --max_epoch "${MAX_EPOCH:-200}" --batch_size "${BATCH_SIZE:-4}" \
  --iter_size "${ITER_SIZE:-1}" --exp_gamma 0.99 \
  --voxel_size 0.3 --use_old_pose true \
  --pair_min_dist 5 --pair_max_dist 20 \
  --out_dir "$OUT_DIR" "$@"
