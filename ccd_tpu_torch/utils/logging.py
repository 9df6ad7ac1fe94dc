"""File-backed logging (parity: Logger, Dino/utils/utils.py:160-188) and the
trainers' TensorBoard writer."""

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


def summary_writer(name: str):
    """A TensorBoard ``SummaryWriter`` at ``./tensorboard/<name>``, or None
    (with one warning) where ``torch.utils.tensorboard`` cannot be imported or
    the writer cannot be made: the trainers then log without it, as the JAX
    CLIs do. The import happens here, at call time: it pulls in TensorBoard
    (and TensorFlow where installed), seconds that an import of a CLI module
    should not pay."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        log_dir = os.path.join(".", "tensorboard", name)
        os.makedirs(log_dir, exist_ok=True)
        writer = SummaryWriter(log_dir=log_dir)
    except Exception as e:  # logging only: training goes on without the writer
        logging.warning(f"no TensorBoard writer ({type(e).__name__}: {e}); "
                        "training goes on without one")
        return None
    logging.info(f"TensorBoard: writing {log_dir}")
    return writer
