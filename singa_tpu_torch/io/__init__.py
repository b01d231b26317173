"""IO (counterpart of ``singa_tpu/io``): the ONNX protobuf codec
(``onnx_pb``).  The record files, text and image readers and the data
loaders are not ported yet."""
