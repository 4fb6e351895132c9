"""Per-process dataset execution configuration.

Role-equivalent to the reference's DataContext (reference:
python/ray/data/context.py) — a process-wide singleton consulted at plan
execution time, deliberately small: the streaming executor here has two
tunables (task window, default block count) instead of the reference's
several dozen.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DataContext:
    # Max dataset tasks in flight per execution (pull-based backpressure —
    # reference: streaming_executor_state.py select_operator_to_run caps
    # concurrent tasks by resource budget).
    execution_window: int = 16
    # Default number of blocks for sources that don't specify parallelism
    # (reference: DataContext.min_parallelism / target block sizing).
    default_num_blocks: int = 8
    # Rows per batch when iter_batches is not given a batch_size.
    default_batch_size: int = 256
    # Byte budget for in-flight blocks: the executor shrinks its task
    # window so (in-flight blocks x learned mean block size) stays under
    # this bound (reference: execution/backpressure_policy/ +
    # resource_manager.py budgets).  None disables byte-based backpressure.
    max_in_flight_bytes: "int | None" = 256 * 1024 * 1024
    # The byte budget never shrinks the window below this floor (keeps the
    # pipeline from collapsing to serial on one huge block).
    min_execution_window: int = 2
    # Stats of the most recent plan execution in this process:
    # {"peak_in_flight": int, "submitted": int, "effective_window_min": int}.
    last_execution_stats: dict = dataclasses.field(default_factory=dict)
    # Stats of the most recent iterator.device_prefetch in this process:
    # device, batches, bytes, whether every staging tensor was pinned, the
    # copy stream's and the consumers' stream ids, each batch's copy time
    # (ms, CUDA events; filled when the iteration ends) and the consumer's
    # host wait for each batch (s).
    last_prefetch_stats: dict = dataclasses.field(default_factory=dict)

    _current = None

    @staticmethod
    def get_current() -> "DataContext":
        if DataContext._current is None:
            DataContext._current = DataContext()
        return DataContext._current
