"""Plain reference implementations of what the benchmark serves.

Plain PyTorch and NumPy, float32 (float64 for the scan) with TF32 off.  No
module here imports ``jax``, the JAX package or anything of ``repro_torch``:
each works from a configuration file's numbers, the weights and inputs the
benchmark made, and the rows the program was handed, and works out again
everything the program derived from them.  One module a model family
(``<model_type>.py``, found by the configuration file's ``model_type``), and
``ivf.py`` for the exact scan.
"""
