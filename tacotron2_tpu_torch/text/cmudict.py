"""CMU pronouncing dictionary parser.

Behavioral parity with reference tacotron/utils/cmudict.py (valid symbol set, alternate
pronunciation handling via ``WORD(1)`` suffixes, latin-1 decoding, ambiguity filtering).
"""

import re
from typing import IO, List, Optional, Union

VALID_ARPABET_SYMBOLS = [
    'AA', 'AA0', 'AA1', 'AA2', 'AE', 'AE0', 'AE1', 'AE2', 'AH', 'AH0', 'AH1', 'AH2',
    'AO', 'AO0', 'AO1', 'AO2', 'AW', 'AW0', 'AW1', 'AW2', 'AY', 'AY0', 'AY1', 'AY2',
    'B', 'CH', 'D', 'DH', 'EH', 'EH0', 'EH1', 'EH2', 'ER', 'ER0', 'ER1', 'ER2', 'EY',
    'EY0', 'EY1', 'EY2', 'F', 'G', 'HH', 'IH', 'IH0', 'IH1', 'IH2', 'IY', 'IY0', 'IY1',
    'IY2', 'JH', 'K', 'L', 'M', 'N', 'NG', 'OW', 'OW0', 'OW1', 'OW2', 'OY', 'OY0',
    'OY1', 'OY2', 'P', 'R', 'S', 'SH', 'T', 'TH', 'UH', 'UH0', 'UH1', 'UH2', 'UW',
    'UW0', 'UW1', 'UW2', 'V', 'W', 'Y', 'Z', 'ZH',
]

_VALID = frozenset(VALID_ARPABET_SYMBOLS)
_ALT_SUFFIX = re.compile(r'\([0-9]+\)')


class CMUDict:
    """Word → list-of-ARPAbet-pronunciations lookup."""

    def __init__(self, file_or_path: Union[str, IO], keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding='latin-1') as f:
                entries = _parse(f)
        else:
            entries = _parse(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        return self._entries.get(word.upper())


def _parse(lines) -> dict:
    out: dict = {}
    for line in lines:
        if not line or not (line[0] == "'" or 'A' <= line[0] <= 'Z'):
            continue
        parts = line.split('  ')
        if len(parts) < 2:
            continue
        word = _ALT_SUFFIX.sub('', parts[0])
        pron = _validate_pronunciation(parts[1])
        if pron is not None:
            out.setdefault(word, []).append(pron)
    return out


def _validate_pronunciation(s: str) -> Optional[str]:
    phones = s.strip().split(' ')
    if any(p not in _VALID for p in phones):
        return None
    return ' '.join(phones)
