"""The benchmark's harness: cells found by name (``spec``), the drivers
(``serve``), the yardstick, the trace reduction and the result
line."""
