"""tacotron2_tpu_torch: the PyTorch / CUDA port of tacotron2_tpu for NVIDIA Hopper.

Sits beside the JAX package, which stays the reference, and imports nothing of it:
no jax, flax or optax, and no `tacotron2_tpu` module. It keeps its own copies of the
pure-Python `config` (Hparams, the default and paper profiles) and `text` (the
frontend), which tests/test_torch_paper.py holds to the originals.
"""

__version__ = '0.1.0'
