"""FCGF baseline tester, the counterpart of ``scripts/test_fcgf.py`` (the
reference's FCGF_APR/scripts/test_fcgf.py).

As :mod:`apr_torch.scripts.test_apr`, but it loads the run's
best-validation checkpoint (the newest numbered one if there is none) and
subsamples exactly ``--num_points`` points of cloud 0 before matching
(``test_subsample``).

    python -m apr_torch.scripts.test_fcgf --save_dir ./outputs/fcgf_kitti \\
        [--num_points 5000] [--num_pairs 100] [--device cuda]
"""

import argparse
import logging
import sys

from apr_torch.scripts.test_apr import add_common_flags, eval_config, \
    run_eval


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="apr_torch FCGF tester")
    add_common_flags(ap)
    ap.add_argument("--num_points", type=int, default=5000)
    args = ap.parse_args(argv)
    cfg = eval_config(args, test_subsample=args.num_points)
    return run_eval(cfg, args, tag="best")


if __name__ == "__main__":
    main(sys.argv[1:])
