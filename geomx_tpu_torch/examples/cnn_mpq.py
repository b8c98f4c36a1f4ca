"""Mixed-Precision Quantization (port of examples/cnn_mpq.py): tiny
tensors travel fp16, large tensors Bi-Sparse; the split bound comes from
GEOMX_SIZE_LOWER_BOUND / MXNET_KVSTORE_SIZE_LOWER_BOUND (default 200000)."""

from geomx_tpu_torch.examples.cnn_common import run


def main(argv=None, **kw):
    return run(extra_args=[("-bcr", "--bsc-compression-ratio", float, 0.01)],
               config_fn=lambda a: {
                   "compression": f"mpq,{a.bsc_compression_ratio}"},
               argv=argv, **kw)


if __name__ == "__main__":
    main()
