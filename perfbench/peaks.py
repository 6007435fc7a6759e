"""The chips' published peaks (``peaks.json``), by device name."""

import json
from pathlib import Path

_TABLE = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def for_device(kind: str):
    """The peaks of the first table entry whose key is in ``kind`` (the
    name ``torch.cuda.get_device_name`` gives), or None."""
    for key, peak in _TABLE.items():
        if key in kind:
            return peak
    return None
