"""Logging helpers (`fastforward_tpu/utils/logging_utils.py`)."""

import logging


class DuplicateLogFilter(logging.Filter):
    """Suppress repeated messages per log level (reference
    `logging_utils.py:9`)."""

    def __init__(self, levels: tuple[int, ...] = (logging.WARNING,)):
        super().__init__()
        self.levels = set(levels)
        self._seen: set[tuple[int, str]] = set()

    def filter(self, record: logging.LogRecord) -> bool:
        if record.levelno not in self.levels:
            return True
        key = (record.levelno, record.getMessage())
        if key in self._seen:
            return False
        self._seen.add(key)
        return True
