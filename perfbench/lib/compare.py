"""The numbers a run compares, each with its limit.

Where the control runs (``faults["control"]``), it stands in the
program's place: its readings are judged under the program's names and
limits, so a run with the control comes out not correct when the
comparison separates the two.  The program's own readings of those
numbers follow as ``program_<name>``, shown and not judged, so one run
gives both readings a limit is set from.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def compared(numbers: Dict[str, float], limits: Dict[str, float],
             control: Optional[Dict[str, float]] = None) -> List[Dict]:
    """Check entries ``{name, value, limit, info}``: a number without a
    limit in ``limits`` is shown only (``info``)."""
    control = control or {}
    out = [{"name": k, "value": control.get(k, v), "limit": limits.get(k),
            "info": k not in limits} for k, v in numbers.items()]
    out += [{"name": f"program_{k}", "value": numbers[k], "limit": None,
             "info": True} for k in control]
    return out


def passed(checks: List[Dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks if not c["info"])
