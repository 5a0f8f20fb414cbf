"""The comparison that decides ``correct``: every record of every chunk
the window returned, lane by lane, against the reference's lanes for
the same records. A record counts as mismatched when any kept lane
differs, and as missing when its chunk came back short."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

#: each number compared, with its limit (an exact comparison: 0)
LIMITS = {"mismatched_records": 0, "missing_records": 0}


def compare(kept: Iterable[Tuple[int, int, Dict[str, np.ndarray]]],
            expected: Dict[str, np.ndarray]) -> Dict[str, int]:
    mismatched = 0
    missing = 0
    compared = 0
    for start, n, lanes in kept:
        got_n = min((len(v) for v in lanes.values()), default=0)
        if set(lanes) != set(expected):
            got_n = 0                      # a lane never came back
        got_n = min(got_n, n)
        missing += n - got_n
        bad = np.zeros(got_n, dtype=bool)
        for k, want in expected.items():
            if k in lanes:
                bad |= (np.asarray(lanes[k][:got_n])
                        != want[start:start + got_n])
        mismatched += int(bad.sum())
        compared += got_n
    return {"mismatched_records": mismatched, "missing_records": missing,
            "records_compared": compared}


def passed(readings: Dict[str, int]) -> bool:
    return all(readings[k] <= lim for k, lim in LIMITS.items())
