#!/bin/bash
# APR on nuScenes, the counterpart of scripts/train_apr_nuscenes.sh
# (reference train_apr_nuscenes.sh: symmetric ResUNet decoder,
# use_old_pose=true, mutate 0.9) for the PyTorch port, on the CUDA card.
set -e
cd "$(dirname "$0")/../.."
export OUT_DIR=${OUT_DIR:-./outputs/apr_nuscenes_$(date +%Y%m%d_%H%M%S)}
# extra flags pass through; tuple flags take their field's element type
# (ROADMAP, "Faults of the reference": train.py:33-34)
python -m apr_torch.train \
  --trainer GenerativePairTrainer \
  --dataset PairComplementNuscenesDataset \
  --kitti_root "${NUSC_ROOT:-./data/nuscenes}" \
  --model ResUNetFatBN --model_n_out 128 --conv1_kernel_size 5 \
  --symmetric true --generator_model ResUNetFatBN \
  --point_generation_ratio 4 \
  --optimizer SGD --lr "${LR:-1e-1}" --loss_ratio 2e-3 \
  --max_epoch "${MAX_EPOCH:-200}" --batch_size "${BATCH_SIZE:-4}" \
  --voxel_size 0.3 --use_old_pose true \
  --pair_min_dist 5 --pair_max_dist 20 \
  --complement_pair_dist 10 --num_complement_one_side 3 \
  --mutate_neighbour_percentage "${MUTATE:-0.9}" \
  --out_dir "$OUT_DIR" "$@"
