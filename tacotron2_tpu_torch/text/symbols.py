"""Input symbol inventory for the character frontend.

Parity with reference tacotron/utils/symbols.py:9-17: pad + eos + 66 ASCII characters.
ARPAbet symbols (prefixed with '@') can be enabled by passing ``arpabet=True`` to
``build_symbols`` — the reference keeps them commented out, so the default vocab here
matches the reference's 68-symbol vocabulary exactly.
"""

from .cmudict import VALID_ARPABET_SYMBOLS

PAD = '_'
EOS = '~'
_CHARACTERS = 'ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!\'\"(),-.:;? '


def build_symbols(arpabet: bool = False):
    syms = [PAD, EOS] + list(_CHARACTERS)
    if arpabet:
        syms += ['@' + s for s in VALID_ARPABET_SYMBOLS]
    return syms


symbols = build_symbols()
