"""Structured logging (observe/logging.rs re-design): fmt/JSON handlers,
env-filter, dev/prod/quiet profiles.

PyTorch counterpart of ``r4w_tpu.observe.logging``; the logger tree is
``r4w_tpu_torch``."""

from __future__ import annotations

import json
import logging
import os
import sys
import time

ROOT = "r4w_tpu_torch"


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        d = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.gmtime(record.created)),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            d["exception"] = self.formatException(record.exc_info)
        return json.dumps(d)


PROFILES = {
    "dev": dict(level=logging.DEBUG, json=False),
    "prod": dict(level=logging.INFO, json=True),
    "quiet": dict(level=logging.WARNING, json=False),
}


def init_logging(profile: str = "dev", json_output: bool | None = None,
                 level: str | None = None) -> logging.Logger:
    """Configure the ``r4w_tpu_torch`` logger tree (observe/logging.rs:84-169).

    Env override: R4W_LOG=debug|info|warning|error (env-filter analogue).
    """
    cfg = dict(PROFILES.get(profile, PROFILES["dev"]))
    if json_output is not None:
        cfg["json"] = json_output
    env = os.environ.get("R4W_LOG")
    if level:
        cfg["level"] = getattr(logging, level.upper())
    elif env:
        cfg["level"] = getattr(logging, env.upper(), logging.INFO)

    logger = logging.getLogger(ROOT)
    logger.setLevel(cfg["level"])
    logger.handlers.clear()
    handler = logging.StreamHandler(sys.stderr)
    if cfg["json"]:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s: %(message)s",
            datefmt="%H:%M:%S",
        ))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{name}" if name else ROOT)
