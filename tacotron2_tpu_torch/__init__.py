"""tacotron2_tpu_torch: the PyTorch / CUDA port of tacotron2_tpu for NVIDIA Hopper.

Sits beside the JAX package, which stays the reference. It reuses
`tacotron2_tpu.config` (Hparams) and `tacotron2_tpu.text` (the text frontend), both
pure Python, and imports nothing else from the JAX package: no jax, flax or optax.
"""

__version__ = '0.1.0'
