"""The program's own records, read after the run: the host spans and
device stage times that `rebvo_tpu_torch.obs` keeps in a ring in this
process (the harness's process runs one cell, so the ring holds that
cell's records only). Each record is handed over as a plain dict of its
fields plus `unit`, the index of its unit (one entry call) in the ring.
Empty where the program keeps no such ring."""

from __future__ import annotations

from typing import List


def records() -> List[dict]:
    try:
        from rebvo_tpu_torch import obs
    except ImportError:
        return []
    return [dict(r._asdict(), unit=i)
            for i, u in enumerate(obs.units()) for r in u.records]
