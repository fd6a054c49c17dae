"""Logger singleton doubling as the global shutdown flag.

Reference: ``common/utils/Logger.hpp:16-77`` — a spdlog wrapper whose
``exitProgram``/``isProgramExit`` flag is the graceful-shutdown signal every
resident thread observes. We keep that exact role: ``Logger.get_instance()``
returns the process logger; ``exit_program()`` trips an ``threading.Event``
that all resident threads/queues watch.
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Optional


class Logger:
    _lock = threading.Lock()
    _instance: Optional["Logger"] = None

    def __init__(self, log_file: Optional[str] = None, level: int = logging.INFO):
        self._exit = threading.Event()
        self._logger = logging.getLogger("simpleslam_tpu_torch")
        self._logger.setLevel(level)
        self._logger.handlers.clear()
        fmt = logging.Formatter(
            "[%(asctime)s.%(msecs)03d] [%(threadName)s] [%(levelname).1s] %(message)s",
            datefmt="%H:%M:%S",
        )
        handler: logging.Handler
        if log_file:
            handler = logging.FileHandler(log_file, mode="w")
        else:
            handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(fmt)
        self._logger.addHandler(handler)

    @classmethod
    def get_instance(cls, log_file: Optional[str] = None) -> "Logger":
        with cls._lock:
            if cls._instance is None:
                cls._instance = Logger(log_file)
            return cls._instance

    getInstance = get_instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None

    # -- shutdown flag (Logger.hpp:48-53 semantics) --------------------------
    def exit_program(self) -> None:
        self._exit.set()

    def is_program_exit(self) -> bool:
        return self._exit.is_set()

    @property
    def exit_event(self) -> threading.Event:
        return self._exit

    # -- log levels ----------------------------------------------------------
    def debug(self, msg: str, *args) -> None:
        self._logger.debug(msg, *args)

    def info(self, msg: str, *args) -> None:
        self._logger.info(msg, *args)

    def warn(self, msg: str, *args) -> None:
        self._logger.warning(msg, *args)

    warning = warn

    def error(self, msg: str, *args) -> None:
        self._logger.error(msg, *args)

    def set_level(self, level: int) -> None:
        self._logger.setLevel(level)
