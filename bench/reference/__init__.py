"""Plain PyTorch references of the benchmark's training steps.

They import neither ``jax``, the JAX package ``repro`` nor anything of
``repro_torch``: each works the step out again from the inputs the
benchmark makes (``bench.inputs``) and the configuration's file.
"""
