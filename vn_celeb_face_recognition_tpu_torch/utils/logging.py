"""Logging setup: console + rotating per-run file handler.

Counterpart of ``vn_celeb_face_recognition_tpu/utils/logging.py``: console
DEBUG with bare messages, and a rotating ``info.txt`` (10 MB x 20
backups) in the run's log directory.
"""

import copy
import logging
import logging.config
from pathlib import Path

DEFAULT_LOGGING_CONFIG = {
    "version": 1,
    "disable_existing_loggers": False,
    "formatters": {
        "simple": {"format": "%(message)s"},
        "datetime": {
            "format": "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
        },
    },
    "handlers": {
        "console": {
            "class": "logging.StreamHandler",
            "level": "DEBUG",
            "formatter": "simple",
            "stream": "ext://sys.stdout",
        },
        "info_file_handler": {
            "class": "logging.handlers.RotatingFileHandler",
            "level": "INFO",
            "formatter": "datetime",
            "filename": "info.txt",
            "maxBytes": 10485760,
            "backupCount": 20,
            "encoding": "utf8",
        },
    },
    "root": {"level": "INFO", "handlers": ["console", "info_file_handler"]},
}


def setup_logging(log_dir, config_dict=None, default_level=logging.INFO):
    """Configure the root logger to print to the console and write
    ``info.txt`` under ``log_dir``."""
    log_dir = Path(log_dir)
    cfg = copy.deepcopy(config_dict or DEFAULT_LOGGING_CONFIG)
    for handler in cfg.get("handlers", {}).values():
        if "filename" in handler:
            handler["filename"] = str(log_dir / Path(handler["filename"]).name)
    try:
        logging.config.dictConfig(cfg)
    except (ValueError, TypeError, AttributeError, ImportError):
        logging.basicConfig(level=default_level)
