"""TFRecord input plane of the port: container I/O, the CTR Example codec,
the synthetic data generator and the per-record input pipeline."""
