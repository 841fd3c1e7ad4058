#!/bin/bash
# APR eval on nuScenes, the counterpart of scripts/test_apr_nuscenes.sh
# for the PyTorch port, on the CUDA card.
set -e
cd "$(dirname "$0")/../.."
python -m apr_torch.scripts.test_apr \
  --save_dir "${SAVE_DIR:?set SAVE_DIR}" \
  --kitti_root "${NUSC_ROOT:-./data/nuscenes}" \
  --dataset PairComplementNuscenesDataset \
  --LoNUSCENES "${LONUSCENES:-true}" "$@"
