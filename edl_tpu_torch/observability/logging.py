"""Structured key=value logging over stdlib logging."""

from __future__ import annotations

import logging


class StructuredLogger:
    """``log.info("msg", key=value, ...)``."""

    def __init__(self, name: str) -> None:
        self._log = logging.getLogger(f"edl_tpu_torch.{name}")

    @staticmethod
    def _fmt(msg: str, kv: dict) -> str:
        if not kv:
            return msg
        return msg + " " + " ".join(f"{k}={v!r}" for k, v in kv.items())

    def info(self, msg: str, **kv) -> None:
        self._log.info(self._fmt(msg, kv), stacklevel=2)

    def warn(self, msg: str, **kv) -> None:
        self._log.warning(self._fmt(msg, kv), stacklevel=2)

    def error(self, msg: str, **kv) -> None:
        self._log.error(self._fmt(msg, kv), stacklevel=2)


def get_logger(name: str) -> StructuredLogger:
    return StructuredLogger(name)
