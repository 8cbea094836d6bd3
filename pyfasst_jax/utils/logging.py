"""Structured run logging and profiling hooks.

SURVEY.md §5: the reference prints log-likelihoods from the GEM loop; the
rebuild provides structured per-run metrics (JSONL for the bench harness)
and jax.profiler trace hooks around the jitted phases.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("pyfasst_jax")


class JSONLWriter:
    """Append-only JSONL metrics sink (one dict per line)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, record: Dict[str, Any]) -> None:
        with open(self.path, "a") as fh:
            fh.write(json.dumps(record) + "\n")


@contextlib.contextmanager
def phase_timer(name: str, sink: Optional[JSONLWriter] = None,
                **fields):
    """Wall-clock a pipeline phase; logs and optionally emits JSONL.

    Dispatch is asynchronous: end the block with jax.block_until_ready on
    its results, or the time measures only the enqueue.
    """
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    logger.info("%s: %.3f s", name, dt)
    if sink is not None:
        sink.write({"phase": name, "seconds": dt, "ts": time.time(),
                    **fields})


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """jax.profiler trace around a phase (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def gem_metrics_record(logliks, seconds: float, audio_seconds: float,
                       niter: int, **extra) -> Dict[str, Any]:
    """The per-run record the bench harness emits (SURVEY.md §5)."""
    import numpy as np
    ll = np.asarray(logliks, np.float64)
    return {
        "niter": int(niter),
        "loglik_first": float(ll[0]),
        "loglik_last": float(ll[-1]),
        "loglik_monotone_frac": float(np.mean(np.diff(ll) >= 0)),
        "seconds": float(seconds),
        "iters_per_sec": float(niter / max(seconds, 1e-12)),
        "xrt": float(audio_seconds / max(seconds, 1e-12)),
        **extra,
    }
