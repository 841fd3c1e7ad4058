"""YAML entry point, the counterpart of the root ``main.py`` (the
reference's Predator_APR/main.py).

    python -m apr_torch.main configs/train/kitti.yaml [--device cpu]
    python -m apr_torch.main configs/test/kitti.yaml

The YAML's sections flatten onto :class:`apr_torch.config.APRConfig`; its
``mode`` (train / val / test, default train) dispatches: train and val run
the training loop of the config's trainer, test evaluates the weights of
``weights`` (a training run's ``out_dir``) and writes ``results.npz`` into
``out_dir``.
"""

import argparse
import logging
import sys

from apr_torch.config import APRConfig, flatten, read_yaml


def main(path: str, device="cuda"):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    flat = flatten(read_yaml(path))
    mode = flat.pop("mode", "train")
    cfg = APRConfig.from_dict(flat)

    predator = cfg.trainer == "PredatorTrainer"
    # the reference calibrates the neighbourhood limits on the train set
    # unless the YAML pins them (Predator_APR/main.py:94-111)
    if predator and mode == "train" and "neighborhood_limits" not in flat:
        cfg.neighborhood_limits_pinned = False

    if mode in ("train", "val"):
        if predator:
            from apr_torch.training.predator_loop import \
                run_predator_training

            summary = run_predator_training(cfg, device=device)
        else:
            from apr_torch.training.loop import run_training

            summary = run_training(cfg, device=device)
        logging.info("done: %s", summary)
        return summary

    if mode == "test":
        from apr_torch.data.datasets import make_dataset
        from apr_torch.training.checkpoints import CheckpointManager

        ds = make_dataset(cfg, "test")
        if predator:
            from apr_torch.eval.predator_tester import PredatorTester
            from apr_torch.training.predator import PredatorTrainer

            trainer = PredatorTrainer(cfg, device=device, seed=cfg.seed)
            tester_cls = PredatorTester
        else:
            from apr_torch.eval.tester import FeatureTester
            from apr_torch.training.trainer import get_trainer

            trainer = get_trainer(cfg, device=device, seed=cfg.seed)
            tester_cls = FeatureTester
        if cfg.weights:
            CheckpointManager(cfg.weights).restore_weights_only(trainer)
        tester = tester_cls(cfg, trainer, device=device)
        stats = tester.test(ds.get_pair(i) for i in range(len(ds)))
        stats.save(cfg.out_dir)
        logging.info("test summary: %s", stats.summary())
        return stats.summary()

    raise ValueError(f"unknown mode: {mode}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="apr_torch YAML entry point")
    ap.add_argument("config", help="a YAML such as configs/train/kitti.yaml")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(sys.argv[1:])
    main(args.config, device=args.device)
