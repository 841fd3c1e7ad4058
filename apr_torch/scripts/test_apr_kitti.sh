#!/bin/bash
# APR-KITTI eval launcher, the counterpart of scripts/test_apr_kitti.sh
# (reference FCGF_APR/scripts/test_apr_kitti.sh) for the PyTorch port,
# on the CUDA card (pass --device cpu to run on the CPU).
set -e
cd "$(dirname "$0")/../.."

export KITTI_ROOT=${KITTI_ROOT:-./data/kitti}
export SAVE_DIR=${SAVE_DIR:?set SAVE_DIR to a training output dir}
export LOKITTI=${LOKITTI:-true}
export MIN_DIST=${MIN_DIST:-40}
export MAX_DIST=${MAX_DIST:-50}

python -m apr_torch.scripts.test_apr \
  --save_dir "$SAVE_DIR" \
  --kitti_root "$KITTI_ROOT" \
  --LoKITTI "$LOKITTI" \
  --pair_min_dist "$MIN_DIST" \
  --pair_max_dist "$MAX_DIST" \
  "$@"
