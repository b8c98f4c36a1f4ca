"""The port's demo entry points, counterparts of the JAX package's
``examples/`` with the same flags, defaults and output lines::

    python -m geomx_tpu_torch.examples.cnn_bsc [-c] [-d mnist] [-ep 5] ...

They run on ``cuda`` unless ``-c/--cpu`` asks for the CPU, and raise
without a GPU otherwise.  The topology and the other knobs come from the
``GEOMX_*`` environment, as the launch scripts set it."""
