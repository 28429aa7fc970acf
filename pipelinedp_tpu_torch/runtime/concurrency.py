"""Lock-discipline declarations (pipelinedp_tpu/runtime/concurrency.py).

A module or class states which attributes a lock guards:

    class BlockJournal:
        _GUARDED_BY = guarded_by("_lock", "_mem")

    _GUARDED_BY = guarded_by("_lock", "counters", "_gauges")

The declaration is the contract every access keeps (inside ``with
<lock>:``; ``__init__`` and module-scope initialization are exempt).
Deliberately lock-free attributes (single-writer publishes such as
``trace._enabled``) are not declared.
"""

from typing import Tuple


def guarded_by(lock: str, *attrs: str) -> Tuple[str, Tuple[str, ...]]:
    """Declares that ``attrs`` may only be touched under ``with <lock>:``.
    Returns the declaration as data, so it can be read at run time."""
    if not attrs:
        raise ValueError("guarded_by(lock, *attrs): declare at least one "
                         "guarded attribute")
    return (lock, attrs)
