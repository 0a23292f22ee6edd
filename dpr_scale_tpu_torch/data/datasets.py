"""Memory-mapped random-access datasets over JSONL / TSV files.

The port's copy of the datasets of ``dpr_scale_tpu/data/datasets.py`` that
its dense train / encode / serve paths and the CITADEL retrieval CLI read
(reference: dpr_scale/datamodule/dpr.py:23-159):

  * ``MemoryMappedDataset``      — line-offset random access over an mmap'd file
  * ``MultiSourceDataset``       — sample a random source per index
  * ``CSVDataset``               — TSV with header -> dict rows
  * ``QueryCSVDataset``          — question \\t [answers] eval query files
  * ``QueryTSVDataset``          — TREC-style ``qid \\t query``

The offset index is a packed ``numpy.uint64`` array (~8 bytes/row), scanned
by the native C++ scanner (:mod:`dpr_scale_tpu_torch.utils.native`) when it
builds, else by numpy, and cached next to the data file as
``<file>.offsets.npy`` — the same cache file the JAX package writes.
"""
from __future__ import annotations

import ast
import mmap
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from dpr_scale_tpu_torch.utils.native import scan_line_offsets


class MemoryMappedDataset:
    """Random access to the lines of a (potentially huge) text file.

    The file is mmap'd; a packed uint64 offset array gives O(1) access to
    line ``i`` without holding the data in RAM. With ``header`` the first
    line is skipped from indexing but kept available via ``header``.

    Reference behavior: dpr_scale/datamodule/dpr.py:23-53.
    """

    def __init__(self, path: str, header: bool = False, cache_index: bool = True):
        self.path = path
        self._file = open(path, "rb")
        size = os.fstat(self._file.fileno()).st_size
        if size > 0:
            self.mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        else:
            self.mmap = None
        self.offsets = self._build_or_load_offsets(path, size, cache_index)
        self.header: Optional[str] = None
        if header and len(self.offsets) > 0:
            self.header = self._line_at(0).decode("utf-8").rstrip("\r\n")
            self.offsets = self.offsets[1:]

    def _build_or_load_offsets(self, path: str, size: int, cache: bool) -> np.ndarray:
        if size == 0:
            return np.zeros((0,), dtype=np.uint64)
        cache_path = path + ".offsets.npy"
        if cache and os.path.exists(cache_path):
            try:
                if os.path.getmtime(cache_path) >= os.path.getmtime(path):
                    offs = np.load(cache_path, mmap_mode="r")
                    return np.asarray(offs)
            except (OSError, ValueError):
                pass
        offs = scan_line_offsets(self.mmap, size)
        if cache:
            try:
                np.save(cache_path, offs)
            except OSError:
                pass  # read-only data dir; index just stays in memory
        return offs

    def _line_at(self, i: int) -> bytes:
        start = int(self.offsets[i])
        end = self.mmap.find(b"\n", start)
        if end == -1:
            end = len(self.mmap)
        return self.mmap[start:end]

    def __len__(self) -> int:
        return len(self.offsets)

    def __getitem__(self, index: int):
        if index < 0:
            index += len(self)
        if not 0 <= index < len(self):
            raise IndexError(index)
        return self.process_line(self._line_at(index))

    def process_line(self, line: bytes):
        """Subclass hook; the base class returns the raw line bytes."""
        return line


class MultiSourceDataset:
    """A list of datasets sampled uniformly at random per __getitem__.

    ``len`` is the min over sources so every epoch touches each source
    equally. Reference behavior: dpr_scale/datamodule/dpr.py:56-77.
    """

    def __init__(self, datasets: Sequence, seed: int = 0):
        if not datasets:
            raise ValueError("MultiSourceDataset needs at least one dataset")
        self.datasets = list(datasets)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return min(len(d) for d in self.datasets)

    def __getitem__(self, index: int):
        src = int(self._rng.integers(len(self.datasets)))
        return self.datasets[src][index]


def parse_tsv_line(line: str, sep: str = "\t") -> List[str]:
    """Split one TSV line honoring csv-style quoting.

    Matches the reference's per-field unescaping
    (dpr_scale/datamodule/dpr.py:94-100: wrapping double quotes stripped,
    doubled quotes unescaped — psgs_w100.tsv quotes its text fields) and
    additionally keeps quoted fields with embedded separators intact:
    the corpus is written with QUOTE_MINIMAL, so a text field may contain
    real tabs, which the reference's plain split silently mis-shifts.
    Lines without a quote character take a plain-split fast path.
    """
    line = line.rstrip("\r\n")
    if '"' not in line:
        return line.split(sep)
    import csv

    return next(csv.reader([line], delimiter=sep, quotechar='"'))


class CSVDataset(MemoryMappedDataset):
    """TSV with a header row; each row becomes ``{col: value}``.

    Reference behavior: dpr_scale/datamodule/dpr.py:80-106 (used for the
    ``id \\t text \\t title`` passage corpus).
    """

    def __init__(self, path: str, sep: str = "\t", cache_index: bool = True):
        super().__init__(path, header=True, cache_index=cache_index)
        self.sep = sep
        self.columns = parse_tsv_line(self.header, sep) if self.header else []

    def process_line(self, line: bytes) -> Dict[str, str]:
        vals = parse_tsv_line(line.decode("utf-8"), self.sep)
        return dict(zip(self.columns, vals))


class QueryCSVDataset(MemoryMappedDataset):
    """Eval query file: ``question \\t <python-list of answer strings>``.

    The reference parses the answers column with ``eval`` (dpr.py:133);
    ``ast.literal_eval`` is used for safety, falling back to a
    single-answer list for malformed rows.
    """

    def __init__(self, path: str):
        super().__init__(path, header=False)

    def process_line(self, line: bytes) -> Dict[str, object]:
        parts = parse_tsv_line(line.decode("utf-8"))
        question = parts[0]
        answers: List[str] = []
        if len(parts) > 1 and parts[1]:
            try:
                answers = list(ast.literal_eval(parts[1]))
            except (ValueError, SyntaxError):
                answers = [parts[1]]
        return {"question": question, "answers": answers}


class QueryTSVDataset(MemoryMappedDataset):
    """TREC-style query file ``qid \\t query``.

    Reference behavior: dpr_scale/datamodule/dpr.py:139-159.
    """

    def __init__(self, path: str):
        super().__init__(path, header=False)

    def process_line(self, line: bytes) -> Dict[str, str]:
        parts = parse_tsv_line(line.decode("utf-8"))
        return {"id": parts[0], "question": parts[1] if len(parts) > 1 else ""}
