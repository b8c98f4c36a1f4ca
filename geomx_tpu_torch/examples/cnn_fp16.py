"""FP16 low-precision transmission (port of examples/cnn_fp16.py): fp32
compute, 16-bit cross-tier transfers."""

from geomx_tpu_torch.examples.cnn_common import run


def main(argv=None, **kw):
    return run(config_fn=lambda a: {"compression": "fp16"}, argv=argv, **kw)


if __name__ == "__main__":
    main()
