"""A configuration's model operations from its shapes, one file a
configuration (``<config>.py`` with ``forward_flops_per_sample(cfg)``):
the multiply-adds of its convolutions and matrix products, two
operations each; normalizations, activations and softmax not counted."""
