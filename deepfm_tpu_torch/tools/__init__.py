"""The port's command-line tools: :mod:`.libsvm_to_tfrecord`, the data-prep
converter (``python -m deepfm_tpu_torch.tools.<name>``)."""
