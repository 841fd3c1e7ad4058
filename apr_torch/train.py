"""Command-line entry of FCGF training, the counterpart of the root
``train.py`` (the reference's FCGF_APR/train.py and config.py).

Every :class:`apr_torch.config.APRConfig` field is a ``--flag``;
``--resume_dir`` re-applies that run's ``config.json`` under the flags
given and resumes from its newest checkpoint.  ``--device`` (default
``cuda``) names the device; the run raises without a card unless it is
``cpu``.

    python -m apr_torch.train --trainer GenerativePairTrainer \\
        --model ResUNetFatBN --model_n_out 128 --dataset synthetic \\
        --max_epoch 2
"""

import argparse
import dataclasses
import logging
import os
import sys
import typing

from apr_torch.config import APRConfig


def str2bool(v):
    return str(v).lower() in ("true", "1", "yes", "y")


def _flag(tp):
    """argparse keywords for a field of type ``tp``."""
    if typing.get_origin(tp) is typing.Union:   # Optional[X]
        tp = next(a for a in typing.get_args(tp) if a is not type(None))
    if typing.get_origin(tp) is tuple:
        return dict(type=typing.get_args(tp)[0], nargs="+")
    return dict(type=str2bool if tp is bool else tp)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="apr_torch trainer")
    parser.add_argument("--resume_dir", type=str, default=None,
                        help="output dir of a previous run; restores its "
                             "config.json + latest checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda)")
    hints = typing.get_type_hints(APRConfig)
    for f in dataclasses.fields(APRConfig):
        parser.add_argument(f"--{f.name}", default=None, **_flag(
            hints[f.name]))
    return parser


def _parse(argv=None):
    args = build_parser().parse_args(argv)
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and k not in ("resume_dir", "device")}
    if args.resume_dir:
        cfg = APRConfig.load_json(os.path.join(args.resume_dir,
                                               "config.json"))
        cfg = cfg.replace(resume=args.resume_dir, **overrides)
    else:
        cfg = APRConfig().replace(**overrides)
    return cfg, args.device


def config_from_args(argv=None) -> APRConfig:
    """The run's config: the defaults (or ``--resume_dir``'s config.json)
    under the flags given."""
    return _parse(argv)[0]


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    cfg, device = _parse(argv)
    from apr_torch.training.loop import run_training

    summary = run_training(cfg, device=device)
    logging.info("training done: %s", summary)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
