"""Append-style CSV logger.

Port of `uresnet_pytorch_tpu/utils/csvdata.py`, the twin of the upstream
CSVData: ``record(keys, vals)`` buffers one row, ``write()`` emits it
(writing the header on first use), ``flush()`` / ``close()`` manage the file.
"""

from __future__ import annotations

import os
from typing import Sequence


class CSVData:
    def __init__(self, fout: str):
        self.name = fout
        self._fout = None
        self._str = None
        self._dict = {}

    def record(self, keys: Sequence[str], vals: Sequence) -> None:
        for k, v in zip(keys, vals):
            self._dict[k] = v

    def write(self) -> None:
        if self._str is None:
            d = os.path.dirname(self.name)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fout = open(self.name, "w")
            self._fout.write(",".join(self._dict.keys()) + "\n")
            self._str = ",".join("{:f}" if isinstance(v, float) else "{}"
                                 for v in self._dict.values()) + "\n"
        self._fout.write(self._str.format(*self._dict.values()))

    def flush(self) -> None:
        if self._fout:
            self._fout.flush()

    def close(self) -> None:
        if self._fout:
            self._fout.close()
            self._fout = None
