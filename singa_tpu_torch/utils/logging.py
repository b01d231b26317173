"""Logging channels (counterpart of ``singa_tpu/utils/logging.py``):
named channels teeing to ``<dir>/<name>.log`` and/or stderr, and
glog-style checks."""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["init_channel", "get_channel", "CHECK", "CHECK_EQ", "CHECK_GT",
           "CHECK_GE", "LOG"]

_channels = {}
_channel_dir = None
_stderr_default = True


def init_channel(argv0="singa_tpu_torch", dir="", stderr=True):
    """Set the channels' output directory and stderr teeing; channels
    made before the call are reconfigured in place."""
    global _channel_dir, _stderr_default
    _channel_dir = dir or None
    _stderr_default = stderr
    if _channel_dir:
        os.makedirs(_channel_dir, exist_ok=True)
    for name, logger in _channels.items():
        _configure(logger, name)


def _configure(logger, name):
    """(Re)build a channel's handlers from the current settings, closing
    the file handlers of the old ones."""
    for h in list(logger.handlers):
        logger.removeHandler(h)
        if isinstance(h, logging.FileHandler):
            h.close()
    fmt = logging.Formatter(
        "[%(asctime)s %(levelname).1s %(name)s] %(message)s", "%H:%M:%S")
    if _stderr_default:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        logger.addHandler(h)
    if _channel_dir:
        fh = logging.FileHandler(os.path.join(_channel_dir, f"{name}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())


def get_channel(name="global") -> logging.Logger:
    """The named channel, made at the first call."""
    if name in _channels:
        return _channels[name]
    logger = logging.getLogger(f"singa_tpu_torch.{name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    _configure(logger, name)
    _channels[name] = logger
    return logger


def CHECK(cond, msg=""):
    if not cond:
        raise AssertionError(f"CHECK failed: {msg}")


def CHECK_EQ(a, b, msg=""):
    if a != b:
        raise AssertionError(f"CHECK_EQ failed: {a!r} != {b!r} {msg}")


def CHECK_GT(a, b, msg=""):
    if not a > b:
        raise AssertionError(f"CHECK_GT failed: {a!r} <= {b!r} {msg}")


def CHECK_GE(a, b, msg=""):
    if not a >= b:
        raise AssertionError(f"CHECK_GE failed: {a!r} < {b!r} {msg}")


def LOG(level="INFO", *args):
    get_channel().log(getattr(logging, level, logging.INFO),
                      " ".join(str(a) for a in args))
