"""edl_tpu_torch — the PyTorch/CUDA port of edl_tpu for NVIDIA Hopper.

Module paths mirror the JAX package (``edl_tpu/X/y.py`` →
``edl_tpu_torch/X/y.py``).  The package imports torch, numpy and the
standard library only, never jax or anything of ``edl_tpu``.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""
