"""The benchmark's plain reference: the same training step written again in
plain PyTorch, float32, with no kernel of the program, no cache and no
batching tricks.

It imports neither JAX nor the JAX package nor anything of the PyTorch
port: the import guard in ``gxbench/tests/test_gxbench_imports.py`` holds
it to that.  It takes nothing the program made: the benchmark hands it the
same weights and batches it hands the program, and it recomputes the
program's derived state (the bucket layout, the error-feedback buffers,
the optimizer state) itself.

- ``layout.py``: the dc tier's flat bucket layout, recomputed from leaf
  shapes;
- ``precision.py``: the arithmetic a reference op runs in (float32 with
  TF32 off, TF32, or float8 operands for the control);
- ``hips.py``: the hierarchical step (worker mean, the Bi-Sparse dc tier,
  the optimizers) over any family's loss;
- ``resnet_cifar.py``, ``seq_encoder.py``: the families' forward passes
  and the leaf specifications the benchmark draws weights from.
"""
