"""The native TFRecord decoder (``tfrecord_native.cc``, built with g++ at
first use) and its ctypes bindings (``loader``)."""
