"""PyTorch + CUDA port of the TokenDance reproduction.

The JAX package ``repro`` stays the reference; this package imports
nothing of it. Module names mirror ``repro`` so each counterpart is easy
to find. Entry points (``models.init_params``, ``models.from_jax``) run on
the CUDA device unless the caller passes ``device="cpu"``; the serving
engine takes its device from the parameters.
"""
