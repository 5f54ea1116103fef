"""
Time-axis parallelism for scoring a long series, a port of
``gordo_tpu/parallel/sequence.py`` (``:55-221``).

An LSTM's output row ``k`` reads rows ``[k, k + lookback + lookahead)``
only: a fixed halo, not the whole series. So the series is cut into one
contiguous chunk a device; each chunk goes to its device with its right
halo (the next chunk's first ``offset`` rows, where JAX's ``ppermute``
brings them from the neighbour), the port's windowed forward
(``models/nn.py::forward_lstm_windows``) scores the chunk's windows
there, and the outputs are joined and cut to the ``n - offset`` real
windows. Every chunk has ``ceil(n / devices)`` rows, and at least one
halo (JAX's chunk floor); the series is zero-padded to whole chunks, and
the windows that read padding are the ones cut. The last chunk's halo is
zeros (JAX's ring hands it the first chunk's head): only cut windows read
it.

This is one process over the devices it is given, as JAX's in-process
mesh is: the forwards are all launched before any result is read, so on
several cards they overlap. ``devices`` defaults to every visible card.
"""

from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..models.nn import forward_lstm_windows
from ..models.spec import LSTMSpec
from ..ops.windows import model_offset
from ..utils.env import env_int

#: rows above which an LSTM estimator's predict takes the ring; <= 0: never
RING_PREDICT_ROWS_ENV = "GORDO_TPU_RING_PREDICT_ROWS"
DEFAULT_RING_PREDICT_ROWS = 65_536

#: windows a forward batch (the estimators' ``PREDICT_BATCH``)
RING_BATCH = 256


def ring_devices(device: Any = "cuda") -> List[torch.device]:
    """The devices a ring over ``device``'s kind spans: every visible card
    for ``cuda``, else ``device`` alone."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def ring_predict_enabled(n_rows: int, devices: Optional[Sequence[Any]] = None) -> bool:
    """Whether a windowed predict over ``n_rows`` takes the ring: at least
    ``GORDO_TPU_RING_PREDICT_ROWS`` rows (a threshold <= 0 turns it off)
    and more than one device (default :func:`ring_devices`)."""
    threshold = env_int(RING_PREDICT_ROWS_ENV, DEFAULT_RING_PREDICT_ROWS)
    if threshold <= 0:
        return False
    return n_rows >= threshold and len(ring_devices() if devices is None else devices) > 1


def ring_windowed_predict(
    spec: LSTMSpec,
    params: Mapping[str, Mapping[str, Any]],
    X: np.ndarray,
    lookback: int,
    lookahead: int = 0,
    devices: Optional[Sequence[Any]] = None,
) -> np.ndarray:
    """One model's output for every window of the series ``X[n, F]``,
    ``[n - offset, F_out]`` float32 (``offset = lookback + lookahead -
    1``), the time axis cut over ``devices`` (default :func:`ring_devices`);
    ``params`` are the model's (tensors or arrays, no member axis). Equal to
    the windowed forward on one device."""
    devices = [torch.device(d) for d in (ring_devices() if devices is None else devices)]
    offset = halo = model_offset(lookback, lookahead)
    X = np.asarray(X, np.float32)
    n = X.shape[0]
    n_windows = n - offset
    if n_windows <= 0:
        raise ValueError(f"Series of length {n} too short for lookback={lookback}, lookahead={lookahead}")
    chunk = max(-(-n // len(devices)), halo)
    padded = np.zeros((chunk * len(devices) + halo,) + X.shape[1:], np.float32)
    padded[:n] = X
    outs = []
    for d, device in enumerate(devices):
        start = d * chunk
        if start >= n_windows:
            break  # every window of this chunk and after reads padding only
        series = torch.from_numpy(padded[start:start + chunk + halo]).to(device, non_blocking=True)[None]
        stacked = {key: {name: torch.as_tensor(leaf, dtype=torch.float32).to(device)[None]
                         for name, leaf in layer.items()} for key, layer in params.items()}
        order = torch.arange(chunk, device=device)[None]
        outs.append(forward_lstm_windows(spec, stacked, series, order, RING_BATCH)[0])
    return np.concatenate([out.cpu().numpy() for out in outs])[:n_windows]


def ring_windowed_anomaly_scores(
    spec: LSTMSpec,
    params: Mapping[str, Mapping[str, Any]],
    X: np.ndarray,
    y: Optional[np.ndarray],
    lookback: int,
    lookahead: int = 0,
    devices: Optional[Sequence[Any]] = None,
) -> np.ndarray:
    """Each window's squared error against its target row, ``[n - offset,
    F_out]``: :func:`ring_windowed_predict` against ``y`` (default ``X``)
    from row ``offset`` on."""
    y = np.asarray(X if y is None else y, np.float32)
    out = ring_windowed_predict(spec, params, X, lookback, lookahead, devices)
    aligned = y[model_offset(lookback, lookahead):]
    return (out - aligned[: len(out)]) ** 2
