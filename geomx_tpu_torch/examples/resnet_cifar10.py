"""Flagship workload: ResNet-20 on CIFAR10 over the two-tier HiPS replicas
(port of examples/resnet_cifar10.py).  Any sync mode / compression via
the GEOMX_* environment:

  GEOMX_NUM_PARTIES=2 GEOMX_WORKERS_PER_PARTY=4 GEOMX_COMPRESSION=bsc,0.01 \\
  python -m geomx_tpu_torch.examples.resnet_cifar10 -ep 1
"""

import sys

from geomx_tpu_torch.examples.cnn_common import run


def main(argv=None, **kw):
    argv = list(sys.argv[1:] if argv is None else argv)
    argv += ["--model", "resnet20", "--dataset", "cifar10"]
    if "--no-augment" in argv:
        argv.remove("--no-augment")
    else:
        argv += ["--augment"]   # the CIFAR recipe needs crop+flip
    return run(extra_args=[("-ee", "--eval-every", int, 50)], argv=argv,
               **kw)


if __name__ == "__main__":
    main()
