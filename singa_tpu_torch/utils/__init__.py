"""Host-side utilities (counterpart of ``singa_tpu/utils``): logging
channels, a timer and training metrics."""
