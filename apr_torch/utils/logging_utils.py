"""Append-only run logger and stdout logging in the reference's format
(port of ``apr_tpu/utils/logging_utils.py``)."""

from __future__ import annotations

import logging
import os
import sys


class Logger:
    """Append lines to {out_dir}/log immediately (crash-safe)."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "log")
        self.fw = open(self.path, "a")

    def write(self, text: str):
        self.fw.write(text)
        self.fw.flush()

    def close(self):
        self.fw.close()


def setup_logging(level=logging.INFO):
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stdout,
        force=True,
    )
