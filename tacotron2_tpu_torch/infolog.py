"""Run logging: console plus a timestamped file (counterpart of
`tacotron2_tpu/utils/infolog.py`, without its Slack webhook). Under several ranks only
rank 0 logs: the others are muted (`mute`)."""

import atexit
from datetime import datetime
from threading import Lock

_format = '%Y-%m-%d %H:%M:%S.%f'
_file = None
_muted = False
_lock = Lock()


def init(filename: str, run_name: str):
    global _file, _muted
    _close_logfile()
    _muted = False
    _file = open(filename, 'a', encoding='utf-8')
    _file.write('\n-----------------------------------------------------------------\n')
    _file.write('Starting new {} training run\n'.format(run_name))
    _file.write('-----------------------------------------------------------------\n')


def mute() -> None:
    """Print and write nothing from now on in this process (a rank other than 0)."""
    global _muted
    _close_logfile()
    _muted = True


def log(msg: str, end: str = '\n'):
    if _muted:
        return
    with _lock:
        print(msg, end=end, flush=True)
        if _file is not None:
            _file.write('[%s]  %s\n' % (datetime.now().strftime(_format)[:-3], msg))
            _file.flush()


def _close_logfile():
    global _file
    if _file is not None:
        _file.close()
        _file = None


atexit.register(_close_logfile)
