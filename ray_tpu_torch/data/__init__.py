"""ray_tpu_torch.data — streaming dataset library (Ray Data equivalent).

Role-equivalent to the reference's Ray Data (reference:
python/ray/data/dataset.py:139 Dataset API;
data/_internal/execution/streaming_executor.py:48 pull-based streaming
execution; data/_internal/execution/operators/output_splitter.py
streaming_split feeding Train workers).  The port of ``ray_tpu/data/``:

- Blocks are Arrow tables at rest and dict-of-numpy batches in flight — the
  batch format a pinned host copy to the card starts from (reference keeps
  Arrow / pandas blocks and converts per-batch, data/block.py:221
  BlockAccessor).  pyarrow, pandas and PIL load lazily: the card's hosts
  may have none of them, and numpy blocks need none.
- Execution is a bounded-window pull pipeline of remote tasks over the
  cluster; ``iter_batches(device=...)`` stages each batch in pinned memory
  and copies it on a side CUDA stream one batch ahead, so the card never
  waits on the host→device copy (``iterator.device_prefetch``).
- `streaming_split(n)` hands blocks to n consumers through a coordinator
  actor (the OutputSplitter analog) so Train workers across nodes each pull
  a disjoint stream.
"""

from .block import Block
from .context import DataContext
from .dataset import (
    ActorPoolStrategy,
    Dataset,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,  # noqa: A001  (shadows builtins.range on purpose, like the reference)
    range_tensor,
    read_csv,
    read_images,
    read_json,
    read_parquet,
)
from .iterator import DataIterator

__all__ = [
    "ActorPoolStrategy", "Block", "DataContext", "Dataset", "DataIterator",
    "from_arrow", "from_items", "from_numpy", "from_pandas",
    "range", "range_tensor", "read_csv", "read_images", "read_json",
    "read_parquet",
]
