"""Natural-eval-driven WaveNet checkpoint selection (counterpart of
`tacotron2_tpu/training/checkpoint_select.py`).

The free-running AR conditioning response can overfit away while the teacher-forced
loss stays healthy, so the newest checkpoint is not always the one to synthesize from.

Three behaviours differ from the JAX module, on purpose (each is a fault recorded
against it): a record whose metric is NaN or infinite never wins `best` (there a NaN
can, by Python's tuple ordering); among records that tie, the earlier step wins for
every metric (there the later step wins the higher-is-better metric); and
`truncate_eval_history` lets a resumed run drop the records past the step it restored
(there they stay and can name a checkpoint the resumed run has not reached).

The training loop appends one JSON record per eval to a sidecar next to the
checkpoint dir (``<ckpt_dir>_eval_history.jsonl``); this module resolves
"best" to a concrete checkpoint step from that history:

- primary metric: ``ar_conditioning_r`` (higher is better) — the in-loop
  free-running conditioning tripwire;
- fallback: ``natural_loss`` (lower is better) — NLL of the free-running
  generation against ground truth;
- last resort: ``teacher_forced_loss`` (lower is better), which cannot see
  the overfit cliff but still beats blind-latest on diverged runs.

Eval steps need not coincide with checkpoint steps (different intervals, and
the manager prunes to max_to_keep), so the best eval step maps to the NEAREST
retained checkpoint step.
"""

import json
import math
import os
from typing import List, Optional, Sequence, Tuple

# metric name -> (higher_is_better,)
_METRICS: Tuple[Tuple[str, bool], ...] = (
    ('ar_conditioning_r', True),
    ('natural_loss', False),
    ('teacher_forced_loss', False),
)


def eval_history_path(checkpoint_dir: str) -> str:
    """Sidecar path for a checkpoint dir (kept beside it, as the JAX package does)."""
    d = os.path.abspath(checkpoint_dir)
    return os.path.join(os.path.dirname(d),
                        os.path.basename(d).rstrip('/') + '_eval_history.jsonl')


def append_eval_record(checkpoint_dir: str, record: dict) -> None:
    """Append one eval record (must contain 'step'); never raises — history is
    observability, not a training dependency."""
    try:
        path = eval_history_path(checkpoint_dir)
        clean = {k: v for k, v in record.items() if v is not None}
        with open(path, 'a', encoding='utf-8') as f:
            f.write(json.dumps(clean) + '\n')
    except OSError:
        pass


def load_eval_history(checkpoint_dir: str) -> List[dict]:
    path = eval_history_path(checkpoint_dir)
    if not os.path.isfile(path):
        return []
    records = []
    with open(path, encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and 'step' in rec:
                records.append(rec)
    return records


def truncate_eval_history(checkpoint_dir: str, step: int) -> int:
    """Drop the records past `step` (a run resumed from the checkpoint at `step` will
    write them again). Returns how many were dropped; never raises."""
    records = load_eval_history(checkpoint_dir)
    kept = [r for r in records if int(r['step']) <= step]
    if len(kept) == len(records):
        return 0
    try:
        with open(eval_history_path(checkpoint_dir), 'w', encoding='utf-8') as f:
            for r in kept:
                f.write(json.dumps(r) + '\n')
    except OSError:
        return 0
    return len(records) - len(kept)


def best_eval_step(records: Sequence[dict]) -> Optional[Tuple[int, str, float]]:
    """(step, metric_name, value) of the best eval record, using the highest-
    priority metric that any record carries with a finite value; the earliest step
    among those that tie."""
    for name, higher in _METRICS:
        scored = [(float(r[name]), int(r['step'])) for r in records
                  if isinstance(r.get(name), (int, float)) and math.isfinite(r[name])]
        if not scored:
            continue
        v, s = min(scored, key=lambda vs: (-vs[0] if higher else vs[0], vs[1]))
        return s, name, v
    return None


def nearest_step(target: int, available: Sequence[int]) -> Optional[int]:
    """Closest retained checkpoint step to the target eval step (ties -> the
    earlier step: before a measured overfit cliff is safer than after it)."""
    if not available:
        return None
    return min(sorted(available), key=lambda s: abs(s - target))


def resolve_best_checkpoint(checkpoint_dir: str,
                            available_steps: Sequence[int]) -> Optional[Tuple[int, str]]:
    """Map eval history to a retained checkpoint step.

    Returns (step, reason) or None when there is no usable history — callers
    fall back to latest (the reference behavior) and should say so.
    """
    best = best_eval_step(load_eval_history(checkpoint_dir))
    if best is None:
        return None
    eval_step, metric, value = best
    step = nearest_step(eval_step, available_steps)
    if step is None:
        return None
    reason = '{}={:.4f} at eval step {}'.format(metric, value, eval_step)
    if step != eval_step:
        reason += ' (nearest retained checkpoint: {})'.format(step)
    return step, reason
