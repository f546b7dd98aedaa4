"""The plain reference of the spiral Neural CDE, in plain PyTorch.

It imports nothing of the port, of JAX or of the JAX package.  ``model``
holds the model, its Hermite control, the loss, Adam and the train steps;
each solver is a file of its own, ``<method>.py``, found by the method's
name.  It runs in float64, or in float32 with every matrix product's
operands rounded to TF32 (the control of ``PERF.md``).
"""
