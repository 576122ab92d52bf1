"""Character frontend: text ↔ integer id sequences.

Parity with reference tacotron/utils/text.py:14-76, including curly-brace ARPAbet
escapes ("Turn left on {HH AW1 S} Street."), cleaner dispatch, unknown-symbol
filtering, and EOS appending.
"""

import re
from typing import List, Sequence

from . import cleaners as _cleaners
from .symbols import EOS, PAD, symbols

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}

_curly_re = re.compile(r'(.*?)\{(.+?)\}(.*)')

PAD_ID = _symbol_to_id[PAD]
EOS_ID = _symbol_to_id[EOS]
VOCAB_SIZE = len(symbols)


def text_to_sequence(text: str, cleaner_names: Sequence[str]) -> List[int]:
    """Convert text to symbol ids; `{...}` spans are ARPAbet; EOS is appended."""
    sequence: List[int] = []
    while text:
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_ids(_clean(text, cleaner_names))
            break
        sequence += _symbols_to_ids(_clean(m.group(1), cleaner_names))
        sequence += _arpabet_to_ids(m.group(2))
        text = m.group(3)
    sequence.append(EOS_ID)
    return sequence


def sequence_to_text(sequence: Sequence[int]) -> str:
    out = ''
    for sid in sequence:
        s = _id_to_symbol.get(int(sid))
        if s is None:
            continue
        if len(s) > 1 and s.startswith('@'):
            s = '{%s}' % s[1:]
        out += s
    return out.replace('}{', ' ')


def _clean(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        text = _cleaners.get_cleaner(name)(text)
    return text


def _symbols_to_ids(syms: Sequence[str]) -> List[int]:
    return [_symbol_to_id[s] for s in syms if _keep(s)]


def _arpabet_to_ids(text: str) -> List[int]:
    return _symbols_to_ids(['@' + s for s in text.split()])


def _keep(s: str) -> bool:
    return s in _symbol_to_id and s not in (PAD, EOS)
