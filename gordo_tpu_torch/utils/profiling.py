"""
Opt-in device profiling, the port's ``gordo_tpu/utils/profiling.py``.

With ``GORDO_TPU_PROFILE_DIR`` set, :func:`maybe_trace` records the
enclosed region with ``torch.profiler`` (CPU activities, and CUDA's when
a card is visible) and writes a Chrome trace (``trace.json``, readable in
Perfetto or ``chrome://tracing``) under
``$GORDO_TPU_PROFILE_DIR/<label>/``, where the JAX package writes a
``jax.profiler`` trace for TensorBoard. Unset, it costs nothing. The
server runs a request under it for ``?profile=device``.
"""

import contextlib
import logging
import os

from .env import env_str

logger = logging.getLogger(__name__)

PROFILE_DIR_ENV = "GORDO_TPU_PROFILE_DIR"
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def maybe_trace(label: str):
    """Trace the enclosed region to ``$GORDO_TPU_PROFILE_DIR/<label>/trace.json``
    when the directory is set; nothing otherwise. A trace that cannot be
    written is logged and dropped."""
    trace_dir = env_str(PROFILE_DIR_ENV, None)
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, label)
    logger.info("Profiling %s -> %s", label, path)
    with profile(activities=activities) as profiler:
        yield
    try:
        os.makedirs(path, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(path, TRACE_FILE))
    except OSError as exc:
        logger.warning("profile of %s not written: %r", label, exc)
