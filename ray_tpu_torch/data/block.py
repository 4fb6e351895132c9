"""Data blocks: Arrow tables at rest, dict-of-numpy batches in flight.

Role-equivalent to the reference's Block/BlockAccessor (reference:
python/ray/data/block.py:61 BlockType, :196 BlockMetadata, :221
BlockAccessor; arrow_block.py, pandas_block.py).  Two physical layouts:

- ``pyarrow.Table`` — tabular data read from files; zero-copy slicing.
- ``dict[str, np.ndarray]`` — tensor data (any column may be n-dimensional),
  the layout the device copy (``iterator.device_prefetch``) starts from.  Arrow cannot hold
  multi-dim columns without extension types, so tensor blocks stay numpy.

All transforms normalize through ``to_numpy()``; conversions between the
two layouts are explicit and lossless for 1-D numeric data.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover - pyarrow is in the image
    pa = None

Batch = Dict[str, np.ndarray]


def _normalize_column(values: Any) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype == object and arr.ndim == 0:
        arr = arr.reshape(1)
    return arr


class Block:
    """One immutable chunk of a dataset."""

    __slots__ = ("_data",)

    def __init__(self, data: Union["pa.Table", Batch]):
        self._data = data

    # -- constructors ---------------------------------------------------------

    @staticmethod
    def from_items(items: Sequence[Any]) -> "Block":
        """Rows from a python list.  Dicts become columns; scalars become a
        single ``item`` column (reference: from_items wraps non-dict rows in
        an 'item' column)."""
        if items and isinstance(items[0], dict):
            cols: Dict[str, List[Any]] = {}
            for row in items:
                for k, v in row.items():
                    cols.setdefault(k, []).append(v)
            return Block({k: _normalize_column(v) for k, v in cols.items()})
        return Block({"item": _normalize_column(list(items))})

    @staticmethod
    def from_batch(batch: Batch) -> "Block":
        out: Batch = {}
        n = None
        for k, v in batch.items():
            arr = _normalize_column(v)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(
                    f"batch columns disagree on length: {k} has {len(arr)}, "
                    f"expected {n}"
                )
            out[k] = arr
        return Block(out)

    @staticmethod
    def from_arrow(table: "pa.Table") -> "Block":
        return Block(table)

    # -- introspection --------------------------------------------------------

    @property
    def is_arrow(self) -> bool:
        return pa is not None and isinstance(self._data, pa.Table)

    @property
    def num_rows(self) -> int:
        if self.is_arrow:
            return self._data.num_rows
        if not self._data:
            return 0
        return len(next(iter(self._data.values())))

    @property
    def size_bytes(self) -> int:
        if self.is_arrow:
            return self._data.nbytes
        return sum(a.nbytes for a in self._data.values())

    def columns(self) -> List[str]:
        if self.is_arrow:
            return self._data.column_names
        return list(self._data)

    def schema(self) -> Dict[str, str]:
        if self.is_arrow:
            return {f.name: str(f.type) for f in self._data.schema}
        return {
            k: f"{a.dtype}{list(a.shape[1:]) if a.ndim > 1 else ''}"
            for k, a in self._data.items()
        }

    # -- layout conversions ---------------------------------------------------

    def to_numpy(self) -> Batch:
        if not self.is_arrow:
            return dict(self._data)
        out: Batch = {}
        for name in self._data.column_names:
            col = self._data.column(name)
            if col.num_chunks > 1:
                col = col.combine_chunks()
            elif col.num_chunks == 1:
                col = col.chunk(0)
            try:
                out[name] = col.to_numpy(zero_copy_only=False)
            except (pa.ArrowInvalid, NotImplementedError):
                out[name] = np.asarray(col.to_pylist(), dtype=object)
        return out

    def to_arrow(self) -> "pa.Table":
        if self.is_arrow:
            return self._data
        for k, a in self._data.items():
            if a.ndim > 1:
                raise ValueError(
                    f"column {k!r} is {a.ndim}-D; Arrow tables hold 1-D "
                    "columns only — keep tensor data in numpy blocks"
                )
        return pa.table({k: pa.array(a) for k, a in self._data.items()})

    def to_pandas(self):
        import pandas as pd

        if self.is_arrow:
            return self._data.to_pandas()
        return pd.DataFrame(
            {k: list(v) if v.ndim > 1 else v for k, v in self._data.items()}
        )

    # -- row/slice access -----------------------------------------------------

    def slice(self, start: int, end: int) -> "Block":
        """Zero-copy row range [start, end)."""
        if self.is_arrow:
            return Block(self._data.slice(start, end - start))
        return Block({k: a[start:end] for k, a in self._data.items()})

    def take_rows(self, indices: np.ndarray) -> "Block":
        if self.is_arrow:
            return Block(self._data.take(pa.array(indices)))
        return Block({k: a[indices] for k, a in self._data.items()})

    def select(self, columns: Sequence[str]) -> "Block":
        if self.is_arrow:
            return Block(self._data.select(list(columns)))
        return Block({k: self._data[k] for k in columns})

    def rows(self) -> Iterator[Dict[str, Any]]:
        batch = self.to_numpy()
        keys = list(batch)
        for i in range(self.num_rows):
            yield {k: batch[k][i] for k in keys}

    # -- combination ----------------------------------------------------------

    @staticmethod
    def concat(blocks: Sequence["Block"]) -> "Block":
        blocks = [b for b in blocks if b.num_rows > 0]
        if not blocks:
            return Block({})
        if all(b.is_arrow for b in blocks):
            return Block(pa.concat_tables([b._data for b in blocks]))
        batches = [b.to_numpy() for b in blocks]
        keys = list(batches[0])
        return Block(
            {k: np.concatenate([bt[k] for bt in batches]) for k in keys}
        )

    def __repr__(self) -> str:
        return (
            f"Block(rows={self.num_rows}, "
            f"layout={'arrow' if self.is_arrow else 'numpy'}, "
            f"cols={self.columns()})"
        )
