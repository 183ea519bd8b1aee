"""Training callbacks for batch and epoch ends (the port of
``mxnet_tpu/callback.py``): ``Speedometer``, ``ProgressBar``,
``log_train_metric`` and ``LogValidationMetricsCallback``, each taking
the reference's ``BatchEndParam`` record (epoch, nbatch, eval_metric,
locals), and ``do_checkpoint`` (``model.save_checkpoint``'s parameter
file; a symbol waits for ``mx.sym``, ROADMAP.md queue 1, item 26).
"""
from __future__ import annotations

import logging
import math
import time
from collections import namedtuple

__all__ = ["BatchEndParam", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]

BatchEndParam = namedtuple(
    "BatchEndParam", ["epoch", "nbatch", "eval_metric", "locals"])


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving ``prefix-NNNN.params`` every
    ``period`` epochs via :func:`mxnet_tpu_torch.model.save_checkpoint`
    (``sym`` None; a symbol raises for ``mx.sym``)."""
    from . import model

    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            model.save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the evaluation metric every
    ``period`` batches."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Logs throughput (samples/sec) and metrics every ``frequent``
    batches ."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if not self.init:
            self.init = True
            self.tic = time.time()
            return

        if count % self.frequent != 0:
            return
        elapsed = time.time() - self.tic
        speed = (self.frequent * self.batch_size / elapsed
                 if elapsed > 0 else float("inf"))
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
            msg += "\t%s=%f" * len(name_value)
            logging.info(msg, param.epoch, count, speed,
                         *sum(name_value, ()))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()


class ProgressBar:
    """Text progress bar over a known batch count."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """Epoch-end callback logging validation metrics."""

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
