"""Package version (counterpart of ``singa_tpu/config.py``)."""

VERSION = "0.1.0"
