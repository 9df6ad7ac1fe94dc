"""The benchmark's plain reference of ``ccd_tpu_torch``: a frozen copy of the
port's modules with every hand-written kernel replaced by its plain PyTorch
version and every collective by the identity (one process).

It imports nothing of the program, of ``jax`` or of the JAX package. The
harness runs it in float32 with TF32 off to judge what the program produced
(``portbench/correctness.py``); with :func:`portbench.reference.models.layers.set_fp8`
it is the lower-precision control. Departures from the copied modules:

* ``ops/flash_attention.py``, ``ops/fused_dino_ce.py``, ``ops/bilateral.py``:
  the plain versions alone, under the kernels' names.
* ``parallel/mesh.py``: one process, no group (``world`` is 1, a reduction
  returns its input).
* ``training/*_step.py``: the checkpoint payload functions left out.
* ``models/layers.py``: :func:`set_fp8` (the control's precision).
"""
