"""The port's text frontend: a copy of `tacotron2_tpu/text/` (pure Python), kept so
that the port imports nothing of the JAX package. `tests/test_torch_paper.py` holds
the copy to the original: the same ids for the same text, the same symbols."""

from .frontend import (EOS_ID, PAD_ID, VOCAB_SIZE, sequence_to_text,
                       text_to_sequence)
from .symbols import symbols

__all__ = ['text_to_sequence', 'sequence_to_text', 'symbols', 'PAD_ID', 'EOS_ID', 'VOCAB_SIZE']
