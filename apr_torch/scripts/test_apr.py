"""APR tester entry, the counterpart of ``scripts/test_apr.py`` (the
reference's FCGF_APR/scripts/test_apr.py).

Rehydrates the training run's ``config.json``, applies the CLI overrides
and this entry's defaults (RANSAC escalation factor 8 with 2 rungs and
confidence 0.999, capacity buckets 2; a 0 pinned in the config stays off),
turns the test rotation on and the scale off, loads the run's newest
checkpoint (weights only), evaluates the test split and writes
``results.npz`` into the run directory.

    python -m apr_torch.scripts.test_apr --save_dir ./outputs/apr_kitti \\
        [--LoKITTI true] [--num_pairs 100] [--device cuda]
"""

import argparse
import dataclasses
import logging
import os
import sys

from apr_torch.config import APRConfig
from apr_torch.train import str2bool


def add_common_flags(ap: argparse.ArgumentParser) -> None:
    """The flags both eval entries take."""
    ap.add_argument("--save_dir", required=True)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--kitti_root", type=str, default=None)
    ap.add_argument("--dataset", type=str, default=None)
    ap.add_argument("--LoKITTI", type=str2bool, default=None)
    ap.add_argument("--pair_min_dist", type=float, default=None)
    ap.add_argument("--pair_max_dist", type=float, default=None)
    ap.add_argument("--num_pairs", type=int, default=None,
                    help="cap the number of test pairs")
    ap.add_argument("--test_ransac_escalation_factor", type=int,
                    default=None,
                    help="adaptive-RANSAC escalation factor "
                         "(0 disables; this entry defaults to 8)")
    ap.add_argument("--test_capacity_buckets", type=int, default=None,
                    help="occupancy-bucket tiers (0 disables; this entry "
                         "defaults to 2)")


def eval_config(args: argparse.Namespace, **fixed) -> APRConfig:
    """The run's ``config.json`` under the flags given (those that name a
    config field), the entry's escalation and bucket defaults unless the
    config or a flag sets them, the test rotation on, the scale off and
    ``fixed``."""
    cfg = APRConfig.load_json(os.path.join(args.save_dir, "config.json"))
    fields = {f.name for f in dataclasses.fields(APRConfig)}
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and k in fields}
    if (cfg.test_ransac_escalation_factor is None
            and "test_ransac_escalation_factor" not in overrides):
        overrides.update(test_ransac_escalation_factor=8,
                         test_ransac_escalation_rungs=2,
                         test_ransac_escalation_confidence=0.999)
    if (cfg.test_capacity_buckets is None
            and "test_capacity_buckets" not in overrides):
        overrides["test_capacity_buckets"] = 2
    return cfg.replace(random_rotation=True, random_scale=False, **fixed,
                       **overrides)


def run_eval(cfg: APRConfig, args: argparse.Namespace, tag=None):
    """Evaluate ``args.save_dir``'s checkpoint (``tag``'s, else the newest
    numbered one) on the test split; writes results.npz there and returns
    the summary."""
    from apr_torch.data.datasets import make_dataset
    from apr_torch.eval.tester import FeatureTester
    from apr_torch.training.checkpoints import CheckpointManager
    from apr_torch.training.trainer import get_trainer

    trainer = get_trainer(cfg, device=args.device, seed=cfg.seed)
    ds = make_dataset(cfg, "test")
    n = len(ds) if args.num_pairs is None else min(len(ds), args.num_pairs)
    mngr = CheckpointManager(args.save_dir)
    try:
        _, meta = mngr.restore_weights_only(trainer, tag=tag)
    except FileNotFoundError:
        if tag is None:
            raise
        _, meta = mngr.restore_weights_only(trainer)
    logging.info("loaded checkpoint at epoch %s (best_val=%s)",
                 meta.get("epoch"), meta.get("best_val"))
    tester = FeatureTester(cfg, trainer, device=args.device)
    stats = tester.test(ds.get_pair(i) for i in range(n))
    stats.save(args.save_dir)
    s = stats.summary()
    logging.info("registration recall %.4f over %d pairs (%.3f pairs/s)",
                 s["recall"], s["n_pairs"], s["pairs_per_sec"])
    if "rte_mean" in s:
        logging.info("RTE %.4f +- %.4f m | RRE %.4f +- %.4f deg",
                     s["rte_mean"], s["rte_std"], s["rre_mean"], s["rre_std"])
    return s


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="apr_torch APR tester")
    add_common_flags(ap)
    ap.add_argument("--LoNUSCENES", type=str2bool, default=None)
    ap.add_argument("--downsample_single", type=float, default=None)
    args = ap.parse_args(argv)
    return run_eval(eval_config(args), args)


if __name__ == "__main__":
    main(sys.argv[1:])
