"""Text cleaner pipelines (reference tacotron/utils/cleaners.py).

``convert_to_ascii`` replaces the reference's unidecode dependency with a
self-contained transliterator: NFKD decomposition + combining-mark stripping plus a
table for characters that do not decompose (ß, æ, ø, þ, …). For English text the
observable behavior matches unidecode.
"""

import re
import unicodedata

_whitespace_re = re.compile(r'\s+')

_ABBREVIATIONS = [(re.compile(r'\b%s\.' % abbr, re.IGNORECASE), full) for abbr, full in [
    ('mrs', 'misess'),
    ('mr', 'mister'),
    ('dr', 'doctor'),
    ('st', 'saint'),
    ('co', 'company'),
    ('jr', 'junior'),
    ('maj', 'major'),
    ('gen', 'general'),
    ('drs', 'doctors'),
    ('rev', 'reverend'),
    ('lt', 'lieutenant'),
    ('hon', 'honorable'),
    ('sgt', 'sergeant'),
    ('capt', 'captain'),
    ('esq', 'esquire'),
    ('ltd', 'limited'),
    ('col', 'colonel'),
    ('ft', 'fort'),
]]

# Characters whose NFKD decomposition does not yield ASCII.
_TRANSLIT_TABLE = {
    'ß': 'ss', 'æ': 'ae', 'Æ': 'AE', 'œ': 'oe', 'Œ': 'OE',
    'ø': 'o', 'Ø': 'O', 'đ': 'd', 'Đ': 'D', 'ð': 'd', 'Ð': 'D',
    'þ': 'th', 'Þ': 'Th', 'ł': 'l', 'Ł': 'L', 'ħ': 'h', 'Ħ': 'H',
    'ŋ': 'ng', 'Ŋ': 'NG', 'ı': 'i', 'ĸ': 'k', 'ſ': 's',
    '—': '-', '–': '-', '‘': "'", '’': "'", '“': '"', '”': '"',
    '…': '...', '«': '"', '»': '"', ' ': ' ',
}


def convert_to_ascii(text: str) -> str:
    text = ''.join(_TRANSLIT_TABLE.get(ch, ch) for ch in text)
    decomposed = unicodedata.normalize('NFKD', text)
    return ''.join(ch for ch in decomposed if ord(ch) < 128)


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREVIATIONS:
        text = regex.sub(replacement, text)
    return text


def expand_numbers(text: str) -> str:
    from .numbers_norm import normalize_numbers
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(' ', text)


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration (reference cleaners.py:69)."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration for non-English text (reference cleaners.py:76)."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """English pipeline: transliterate, expand numbers/abbreviations, collapse whitespace.

    Note: the reference deliberately does NOT lowercase here (cleaners.py:86 comments
    out ``lowercase``); we preserve that."""
    text = convert_to_ascii(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)


_CLEANERS = {
    'basic_cleaners': basic_cleaners,
    'transliteration_cleaners': transliteration_cleaners,
    'english_cleaners': english_cleaners,
}


def get_cleaner(name: str):
    if name not in _CLEANERS:
        raise ValueError(f'Unknown cleaner: {name}')
    return _CLEANERS[name]
