"""English number normalization for the text frontend.

Behavioral parity with reference tacotron/utils/numbers.py (comma removal, pounds,
dollars, decimal points, ordinals, cardinal expansion with year-style handling for
1000<n<3000). The reference delegates word expansion to the ``inflect`` package; that
package is not available here, so this module ships a self-contained English
number-to-words engine producing the same surface forms the reference's pipeline emits
(``andword=''`` style: "one hundred one", groups joined by ", ").
"""

import re

_ONES = ['zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven', 'eight', 'nine',
         'ten', 'eleven', 'twelve', 'thirteen', 'fourteen', 'fifteen', 'sixteen',
         'seventeen', 'eighteen', 'nineteen']
_TENS = ['', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty', 'seventy', 'eighty', 'ninety']
_SCALES = ['', ' thousand', ' million', ' billion', ' trillion', ' quadrillion',
           ' quintillion', ' sextillion', ' septillion', ' octillion', ' nonillion',
           ' decillion']

_ORDINAL_IRREGULAR = {
    'one': 'first', 'two': 'second', 'three': 'third', 'five': 'fifth',
    'eight': 'eighth', 'nine': 'ninth', 'twelve': 'twelfth',
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ('-' + _ONES[ones] if ones else '')


def _three_digits(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    if hundreds and rest:
        return _ONES[hundreds] + ' hundred ' + _two_digits(rest)
    if hundreds:
        return _ONES[hundreds] + ' hundred'
    return _two_digits(rest)


def number_to_words(n: int) -> str:
    """Cardinal words, inflect ``andword=''`` style: groups of three joined by ", "."""
    if n < 0:
        return 'minus ' + number_to_words(-n)
    if n == 0:
        return 'zero'
    groups = []
    scale = 0
    while n > 0:
        n, chunk = divmod(n, 1000)
        if chunk:
            groups.append(_three_digits(chunk) + _SCALES[scale])
        scale += 1
    return ', '.join(reversed(groups))


def number_to_words_grouped2(n: int) -> str:
    """Year-style reading: digit pairs from the left, leading zero in a pair read "oh".

    Matches ``inflect.number_to_words(n, group=2, zero='oh', andword='')`` followed by
    the reference's ``.replace(', ', ' ')`` (numbers.py:57).
    """
    digits = str(n)
    if len(digits) % 2 == 1:
        digits = digits[0] + ' ' + digits[1:]  # should not occur for 4-digit years
    pairs = [digits[i:i + 2] for i in range(0, len(digits), 2)] if ' ' not in digits else None
    if pairs is None:
        head, rest = digits.split(' ')
        pairs = [head] + [rest[i:i + 2] for i in range(0, len(rest), 2)]
    words = []
    for p in pairs:
        v = int(p)
        if len(p) == 2 and p[0] == '0':
            words.append('oh ' + _ONES[v] if v else 'oh oh')
        elif len(p) == 1:
            words.append(_ONES[v])
        else:
            words.append(_two_digits(v))
    return ' '.join(words)


def ordinal_to_words(n: int) -> str:
    cardinal = number_to_words(n)
    # transform the final word into its ordinal form
    head, sep, last = cardinal.rpartition(' ')
    prefix = head + sep
    if '-' in last:
        hy_head, _, hy_last = last.rpartition('-')
        return prefix + hy_head + '-' + _ordinal_word(hy_last)
    return prefix + _ordinal_word(last)


def _ordinal_word(word: str) -> str:
    if word in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[word]
    if word.endswith('y'):
        return word[:-1] + 'ieth'
    return word + 'th'


# --- text-level normalization (reference numbers.py:6-75) ---

_comma_number_re = re.compile(r'([0-9][0-9\,]+[0-9])')
_decimal_number_re = re.compile(r'([0-9]+\.[0-9]+)')
_pounds_re = re.compile(r'£([0-9\,]*[0-9]+)')
_dollars_re = re.compile(r'\$([0-9\.\,]*[0-9]+)')
_ordinal_re = re.compile(r'[0-9]+(st|nd|rd|th)')
_number_re = re.compile(r'[0-9]+')


def _remove_commas(m):
    return m.group(1).replace(',', '')


def _expand_decimal_point(m):
    return m.group(1).replace('.', ' point ')


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split('.')
    if len(parts) > 2:
        return match + ' dollars'
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = 'dollar' if dollars == 1 else 'dollars'
        cent_unit = 'cent' if cents == 1 else 'cents'
        return '%s %s, %s %s' % (dollars, dollar_unit, cents, cent_unit)
    if dollars:
        return '%s %s' % (dollars, 'dollar' if dollars == 1 else 'dollars')
    if cents:
        return '%s %s' % (cents, 'cent' if cents == 1 else 'cents')
    return 'zero dollars'


def _expand_ordinal(m):
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return 'two thousand'
        if 2000 < num < 2010:
            return 'two thousand ' + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + ' hundred'
        return number_to_words_grouped2(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(_remove_commas, text)
    text = _pounds_re.sub(r'\1 pounds', text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(_expand_decimal_point, text)
    text = _ordinal_re.sub(_expand_ordinal, text)
    text = _number_re.sub(_expand_number, text)
    return text
