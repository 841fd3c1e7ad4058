#!/bin/bash
# FCGF eval on KITTI, the counterpart of scripts/test_fcgf_kitti.sh for
# the PyTorch port, on the CUDA card.
set -e
cd "$(dirname "$0")/../.."
python -m apr_torch.scripts.test_fcgf \
  --save_dir "${SAVE_DIR:?set SAVE_DIR}" \
  --kitti_root "${KITTI_ROOT:-./data/kitti}" \
  --LoKITTI "${LOKITTI:-true}" "$@"
