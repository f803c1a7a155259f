"""LibSVM -> TFRecord converter (the port's copy of the JAX repo's
``tools/libsvm_to_tfrecord.py``).

Usage:
    python -m deepfm_tpu_torch.tools.libsvm_to_tfrecord --input tr.libsvm \
        --output tr.tfrecords [--field-size 39] [--num-shards 1]

``--output`` may be a remote URL (``gs://...``) through the fileio seam.
"""

from __future__ import annotations

import argparse

from ..data import libsvm


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="LibSVM text file")
    p.add_argument("--output", required=True, help="output TFRecord path")
    p.add_argument("--field-size", type=int, default=None,
                   help="validate every line has this many features")
    p.add_argument("--num-shards", type=int, default=1)
    args = p.parse_args(argv)
    n = libsvm.convert_libsvm_file(
        args.input, args.output, field_size=args.field_size,
        num_shards=args.num_shards)
    print(f"wrote {n} records to {args.output} ({args.num_shards} shard(s))")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
