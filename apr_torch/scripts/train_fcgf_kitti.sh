#!/bin/bash
# FCGF baseline (no generative branch) on KITTI, the counterpart of
# scripts/train_fcgf_kitti.sh (reference FCGF_APR/scripts/train_fcgf_kitti.sh:
# HardestContrastive, n_out 32) for the PyTorch port, on the CUDA card.
set -e
cd "$(dirname "$0")/../.."
export OUT_DIR=${OUT_DIR:-./outputs/fcgf_kitti_$(date +%Y%m%d_%H%M%S)}
# extra flags pass through; tuple flags take their field's element type
# (ROADMAP, "Faults of the reference": train.py:33-34)
python -m apr_torch.train \
  --trainer HardestContrastiveLossTrainer \
  --dataset PairComplementKittiDataset \
  --kitti_root "${KITTI_ROOT:-./data/kitti}" \
  --model ResUNetBN2C --model_n_out 32 --conv1_kernel_size 5 \
  --optimizer SGD --lr "${LR:-1e-1}" \
  --max_epoch "${MAX_EPOCH:-200}" --batch_size "${BATCH_SIZE:-4}" \
  --voxel_size 0.3 --use_old_pose true \
  --out_dir "$OUT_DIR" "$@"
