"""Hierarchical Frequency Aggregation (port of examples/cnn_hfa.py):
workers update locally, parameter-average within the party every K1 steps
and across parties every K1*K2 steps (K1/K2 from GEOMX_HFA_K1/K2 or
DMLC_K1/K2; the reference demo uses K1=20, K2=10)."""

from geomx_tpu_torch.examples.cnn_common import run


def main(argv=None, **kw):
    return run(sync_default="hfa",
               extra_args=[("-ee", "--eval-every", int, 200)],
               config_fn=lambda a: {}, argv=argv, **kw)


if __name__ == "__main__":
    main()
