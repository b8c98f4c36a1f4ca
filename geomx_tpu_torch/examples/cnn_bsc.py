"""Bi-Sparse gradient-sparsified training (port of examples/cnn_bsc.py).

The -bcr ratio defaults to 0.01 as in the reference; the cross-party push
and pull both move only ~ratio of each large tensor (2*k floats/party)."""

from geomx_tpu_torch.examples.cnn_common import run


def main(argv=None, **kw):
    return run(extra_args=[("-bcr", "--bsc-compression-ratio", float, 0.01)],
               config_fn=lambda a: {
                   "compression": f"bsc,{a.bsc_compression_ratio}"},
               argv=argv, **kw)


if __name__ == "__main__":
    main()
