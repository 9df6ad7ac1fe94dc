"""File-backed logging (parity: Logger, Dino/utils/utils.py:160-188)."""

from __future__ import annotations

import logging
import os


class Logger:
    _handle = None
    _root = None

    @staticmethod
    def init(output_dir: str, name: str, phase: str) -> None:
        fmt = ("[%(asctime)s %(filename)s:%(lineno)d %(levelname)s {}] "
               "%(message)s").format(name)
        logging.basicConfig(level=logging.INFO, format=fmt)
        os.makedirs(output_dir, exist_ok=True)
        Logger._handle = logging.FileHandler(os.path.join(output_dir, f"{phase}.txt"))
        Logger._handle.setFormatter(logging.Formatter(fmt))
        Logger._root = logging.getLogger()

    @staticmethod
    def enable_file() -> None:
        if Logger._handle is None or Logger._root is None:
            raise RuntimeError("Invoke Logger.init() first!")
        Logger._root.addHandler(Logger._handle)

    @staticmethod
    def disable_file() -> None:
        if Logger._handle is None or Logger._root is None:
            raise RuntimeError("Invoke Logger.init() first!")
        Logger._root.removeHandler(Logger._handle)
        Logger._handle.close()
