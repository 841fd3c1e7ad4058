#!/bin/bash
# FCGF eval on nuScenes distant pairs, the counterpart of
# scripts/test_fcgf_nuscenes.sh (reference FCGF_APR/scripts/
# test_fcgf_nuscenes.sh: 5-20 m pairs; set LONUSCENES=true for the 994
# fixed LoNuScenes pairs) for the PyTorch port, on the CUDA card.
set -e
cd "$(dirname "$0")/../.."
# --LoNUSCENES: the port's test_fcgf takes it; the root scripts/test_fcgf.py
# refuses it (ROADMAP, "Faults of the reference")
python -m apr_torch.scripts.test_fcgf \
  --save_dir "${SAVE_DIR:?set SAVE_DIR}" \
  --kitti_root "${NUSC_ROOT:-./data/nuscenes}" \
  --dataset PairComplementNuscenesDataset \
  --pair_min_dist 5 --pair_max_dist 20 \
  --LoNUSCENES "${LONUSCENES:-false}" "$@"
