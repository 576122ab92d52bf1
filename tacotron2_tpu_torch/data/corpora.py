"""Dataset folder selection (LJSpeech / M-AILABS tree walk): the port's copy of
`tacotron2_tpu/data/corpora.py`, held to it by `tests/test_torch_preprocess.py`; change
both sides together.

The supported datasets, the M-AILABS language / voice / reader / book validation with
its error texts, and merge_books.
"""

import os
from typing import List

SUPPORTED_DATASETS = ['LJSpeech-1.0', 'LJSpeech-1.1', 'M-AILABS']
MAILABS_LANGUAGES = ['en_US', 'en_UK', 'fr_FR', 'it_IT', 'de_DE', 'es_ES', 'ru_RU',
                     'uk_UK', 'pl_PL', 'nl_NL', 'pt_PT', 'fi_FI', 'se_SE', 'tr_TR', 'ar_SA']
MAILABS_VOICES = ['female', 'male', 'mix']


def norm_data(base_dir: str, dataset: str, language: str = 'en_US', voice: str = 'female',
              reader: str = 'mary_ann', merge_books: bool = False,
              book: str = 'northandsouth') -> List[str]:
    if dataset not in SUPPORTED_DATASETS:
        raise ValueError(f'dataset {dataset} not in supported datasets: {SUPPORTED_DATASETS}')

    if dataset.startswith('LJSpeech'):
        return [os.path.join(base_dir, dataset)]

    # M-AILABS
    if language not in MAILABS_LANGUAGES:
        raise ValueError(f'unsupported M-AILABS language {language}; choose from {MAILABS_LANGUAGES}')
    if voice not in MAILABS_VOICES:
        raise ValueError(f'unsupported M-AILABS voice {voice}; choose from {MAILABS_VOICES}')

    path = os.path.join(base_dir, language, 'by_book', voice)
    readers = [e for e in os.listdir(path) if os.path.isdir(os.path.join(path, e))]
    if reader not in readers:
        raise ValueError(f'invalid reader for language/voice; available: {readers}')

    path = os.path.join(path, reader)
    books = [e for e in os.listdir(path) if os.path.isdir(os.path.join(path, e))]
    if merge_books:
        return [os.path.join(path, b) for b in books]
    if book not in books:
        raise ValueError(f'invalid book for reader; available: {books}')
    return [os.path.join(path, book)]
