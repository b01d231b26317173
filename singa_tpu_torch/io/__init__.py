"""IO (counterpart of ``singa_tpu/io``): the BinFile record store and
prefetch queue over the native C++ runtime (``binfile``), text-file
records (``textfile``), the JPEG codec (``image``), the threaded BinFile
data loader (``loader``) and the ONNX protobuf codec (``onnx_pb``).

``binfile.CorruptRecordError`` (re-exported here) is the typed
corruption error: a truncated tail record or a CRC mismatch names the
key and the offset, so the checkpoint manager's fallback can log
something actionable."""

from .binfile import CorruptRecordError  # noqa: F401
