"""KST/UTC and CMAQ cycle/lead-time arithmetic as pure functions.

The port's own copy of ``vit_grid_model_tpu/data/timeutil.py``.

Semantics: sample times are KST; CMAQ file lookup is in UTC (``t - 9h``,
``dataset.py:738``).  CMAQ runs initialize daily at 03/09/15/21 UTC and a
run becomes usable 3 hours after its init time, so for a valid (UTC) hour h
the latest usable run of cycle c is yesterday's when ``h >= 3`` and the day
before's otherwise.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import List, NamedTuple, Sequence, Tuple

KST_OFFSET_HOURS = 9
CYCLES = (3, 9, 15, 21)


class CycleRef(NamedTuple):
    """One CMAQ run providing data for a given valid time."""

    cycle: int          # init hour of the daily run (3/9/15/21 UTC)
    date: datetime      # init date (day of the run)
    lead: int           # lead hours from init to the valid time


def kst_to_utc(t_kst: datetime) -> datetime:
    return t_kst - timedelta(hours=KST_OFFSET_HOURS)


def cycle_refs(t_utc: datetime) -> Tuple[CycleRef, CycleRef, CycleRef, CycleRef]:
    """For a UTC valid time, the latest usable run of each daily cycle:
    ``init_datetime(date, cycle) + lead == t_utc`` and ``lead >= 3``."""
    out = []
    for c in CYCLES:
        lead = t_utc.hour + (24 - c)
        if t_utc.hour >= 3:
            date = t_utc - timedelta(days=1)
        else:
            date = t_utc - timedelta(days=2)
            lead += 24
        out.append(CycleRef(c, date, lead))
    return tuple(out)


def cmaq_file_name(sim_data_path: str, ref: CycleRef) -> str:
    """``{sim}/{year}/{mmdd}{cycle:02d}_{lead:02d}.npy``
    (``dataset.py:783``)."""
    return (f"{sim_data_path}/{ref.date.year}/"
            f"{ref.date.strftime('%m%d')}{ref.cycle:02d}_{ref.lead:02d}.npy")


def reanalysis_file_name(reanalysis_data_path: str, t_utc: datetime) -> str:
    """``{path}/{year}/ACONC.PM_RQ40i8a.KNU_09_01.{Ymd}.nc``
    (``dataset.py:739``)."""
    return (f"{reanalysis_data_path}/{t_utc.year}/"
            f"ACONC.PM_RQ40i8a.KNU_09_01.{t_utc.strftime('%Y%m%d')}.nc")


def raw_time_rows(times: Sequence[datetime], mod_idx: int, input_dim: int,
                  total_steps: int) -> List[List[int]]:
    """The (input_dim+output_dim, 4) [year, month, day, hour] rows a sample
    carries (``dataset.py:730-732``)."""
    rows = []
    for t_idx in range(total_steps):
        t = times[mod_idx - input_dim + 1 + t_idx]
        rows.append([t.year, t.month, t.day, t.hour])
    return rows


def hourly_range(start: datetime, end: datetime) -> List[datetime]:
    """Inclusive hourly time list."""
    out, cur = [], start
    while cur <= end:
        out.append(cur)
        cur += timedelta(hours=1)
    return out


def eval_time_list(test_start: datetime, test_end: datetime, prev_len: int,
                   output_dim: int) -> List[datetime]:
    """The padded eval time list: ``start - (prev_len-1)h`` through
    ``end + output_dim h`` (``evaluation_vit.py:116-120``)."""
    return hourly_range(test_start - timedelta(hours=prev_len - 1),
                        test_end + timedelta(hours=output_dim))
