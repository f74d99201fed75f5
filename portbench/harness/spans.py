"""The program's own regions in a traced window: the host events of
``Profile.host`` that carry a region's name (the program's
``core.profiling.annotate``), summed and counted.

A program without a region reads nothing: each helper returns None when
any of the names it was given has no event in the profile.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple


def totals(profile, names: Iterable[str]) -> Optional[Tuple[float, int]]:
    """(seconds, count) of the host events named in ``names``; None without
    a profile, or when a name has no event."""
    if profile is None:
        return None
    counts = dict.fromkeys(names, 0)
    us = 0.0
    for start, end, name in profile.host:
        if name in counts:
            counts[name] += 1
            us += end - start
    if not all(counts.values()):
        return None
    return us / 1e6, sum(counts.values())


def ms_per_unit(profile, names: Iterable[str]) -> Optional[float]:
    """The regions' host ms a batch or step (``Profile.units``)."""
    got = totals(profile, names)
    return None if got is None or not profile.units else got[0] / profile.units * 1e3


def count_per_unit(profile, names: Iterable[str]) -> Optional[float]:
    """The regions' count a batch or step (``Profile.units``)."""
    got = totals(profile, names)
    return None if got is None or not profile.units else got[1] / profile.units


def window_share(profile, names: Iterable[str]) -> Optional[float]:
    """The regions' host time over the traced window, in %."""
    got = totals(profile, names)
    return None if got is None or profile.window_s <= 0 else 100.0 * got[0] / profile.window_s
