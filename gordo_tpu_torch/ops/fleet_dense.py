"""
The fused fleet forward: the counterpart of ``gordo_tpu/ops/pallas_dense.py``.

:func:`fleet_feedforward` runs a feedforward autoencoder's whole layer
stack for many fleet members at once, ``X[M, B, F] -> [M, B, F_out]``.
On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/fleet_dense.cu`` (K1) or raises; on a CPU tensor it runs
:func:`fleet_feedforward_reference`, the plain version. Nothing falls
back from the card to the plain version.

Two things the JAX serving program wraps around its kernel are fused
into the launch here (``gordo_tpu/server/fleet_store.py:838-861``):

- ``indices[M]`` picks each batch row's member out of the resident
  bucket ``W_l[N, d_in, d_out]``, ``b_l[N, d_out]``; the kernel reads the
  member's params in place instead of a gathered copy;
- ``ingest=(scale[N, F], offset[N, F])`` applies the member's compiled
  preprocessing ``X * scale + offset`` in float32 to the loaded tile.

:func:`fleet_anomaly_scores` is the counterpart of
``fleet_anomaly_scores_pallas`` (K2): the same forward, then the per-row
mean squared error against targets ``y``, fused into the same launch as
an epilogue (``fleet_dense.cu``), so the reconstruction is never read
back. Its plain version is :func:`fleet_anomaly_scores_reference`.

``fleet_feedforward.launches`` and ``fleet_anomaly_scores.launches``
count kernel launches (never plain runs), so a caller can show that a
path went through the kernel; ``fleet_feedforward.shapes`` counts K1's
launches by ``X``'s shape ``(M, B, F)``, so a process that launched K1
at several shapes (a fleet build's spec groups) can say which it ran.
"""

import collections
import ctypes
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.spec import FeedForwardSpec
from .activations import activation_code, resolve_activation

Params = Dict[str, Dict[str, torch.Tensor]]
Indices = Union[Sequence[int], np.ndarray, torch.Tensor, None]

#: the kernel's limits (``kMaxLayers``/``kMaxWidth`` in fleet_dense.cu)
MAX_LAYERS = 32
MAX_WIDTH = 512


def _host_indices(indices: Indices, M: int, N: int) -> np.ndarray:
    """``indices`` as a validated host int32 vector (default: 0..M-1)."""
    if indices is None:
        idx = np.arange(M, dtype=np.int64)
    elif isinstance(indices, torch.Tensor):
        idx = indices.detach().cpu().numpy().astype(np.int64)
    else:
        idx = np.asarray(indices, dtype=np.int64)
    if idx.shape != (M,):
        raise ValueError(f"indices has shape {idx.shape}, expected ({M},)")
    if M and (idx.min() < 0 or idx.max() >= N):
        raise IndexError(f"indices out of range for a bucket of {N} members")
    return idx.astype(np.int32)


def _device_indices(indices: Indices, M: int, N: int, device: torch.device) -> torch.Tensor:
    """Validated int32 indices on ``device``. No path waits for the
    device: a pageable host-to-device copy would synchronise the stream,
    so host indices go through pinned memory, and an integer tensor that
    already lies on ``device`` (a card) is used where it is, its range
    unchecked, since reading it back to check would synchronise."""
    if indices is None:
        if M > N:
            raise IndexError(f"indices out of range for a bucket of {N} members")
        return torch.arange(M, dtype=torch.int32, device=device)
    if isinstance(indices, torch.Tensor) and indices.device == device and device.type != "cpu":
        if tuple(indices.shape) != (M,):
            raise ValueError(f"indices has shape {tuple(indices.shape)}, expected ({M},)")
        if indices.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"indices must be int32 or int64, got {indices.dtype}")
        return indices.to(torch.int32).contiguous()
    idx = torch.from_numpy(_host_indices(indices, M, N))
    if device.type == "cuda":
        idx = idx.pin_memory()
    return idx.to(device, non_blocking=True)


def _check(
    spec: FeedForwardSpec, stacked: Params, X: torch.Tensor, ingest, y: Optional[torch.Tensor] = None
) -> int:
    """Validate shapes, dtypes and devices; returns the bucket size N."""
    if X.dim() != 3 or X.shape[-1] != spec.n_features:
        raise ValueError(
            f"X must be [M, B, {spec.n_features}], got {tuple(X.shape)}"
        )
    if y is not None and (y.dim() != 3 or y.shape[:2] != X.shape[:2] or y.shape[-1] < 1):
        raise ValueError(
            f"y must be [{X.shape[0]}, {X.shape[1]}, F_y >= 1] like X, got {tuple(y.shape)}"
        )
    widths = spec.widths()
    N = None
    tensors = []
    for i, (key, _) in enumerate(spec.layer_names()):
        W, b = stacked[key]["W"], stacked[key]["b"]
        if N is None:
            N = W.shape[0]
        if tuple(W.shape) != (N, widths[i], widths[i + 1]) or tuple(b.shape) != (N, widths[i + 1]):
            raise ValueError(
                f"{key}: W {tuple(W.shape)} / b {tuple(b.shape)} do not match "
                f"[{N}, {widths[i]}, {widths[i + 1]}] / [{N}, {widths[i + 1]}]"
            )
        tensors += [W, b]
    if ingest is not None:
        for t in ingest:
            if tuple(t.shape) != (N, spec.n_features):
                raise ValueError(
                    f"ingest arrays must be [{N}, {spec.n_features}], got {tuple(t.shape)}"
                )
        tensors += list(ingest)
    for t in tensors + [X] + ([] if y is None else [y]):
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 tensors, got {t.dtype}")
        if t.device != X.device:
            raise ValueError(f"tensor on {t.device}, X on {X.device}")
    return N


def fleet_feedforward_reference(
    spec: FeedForwardSpec,
    stacked: Params,
    X: torch.Tensor,
    indices: Indices = None,
    ingest: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """The plain version of K1: gather, ingest affine, then a per-layer
    ``bmm`` loop with the activation table. Same arguments and result as
    :func:`fleet_feedforward`."""
    N = _check(spec, stacked, X, ingest)
    idx = _device_indices(indices, X.shape[0], N, X.device).long()
    h = X
    if ingest is not None:
        scale, offset = ingest
        h = h * scale[idx][:, None, :] + offset[idx][:, None, :]
    for key, act in spec.layer_names():
        W = stacked[key]["W"][idx]
        b = stacked[key]["b"][idx]
        h = resolve_activation(act)(torch.bmm(h, W) + b[:, None, :])
    return h


def fleet_anomaly_scores_reference(
    spec: FeedForwardSpec,
    stacked: Params,
    X: torch.Tensor,
    y: torch.Tensor,
    indices: Indices = None,
    ingest: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K2: :func:`fleet_feedforward_reference`, then
    the mean of squared differences over the first ``min(F_out, F_y)``
    columns. Same arguments and result as :func:`fleet_anomaly_scores`."""
    _check(spec, stacked, X, ingest, y)
    recon = fleet_feedforward_reference(spec, stacked, X, indices, ingest)
    w = min(recon.shape[-1], y.shape[-1])
    return recon, torch.square(recon[..., :w] - y[..., :w]).mean(-1)


_kernels: Dict[Tuple[str, ...], Tuple[Callable, Callable]] = {}
_kernels_lock = threading.Lock()
_launches_lock = threading.Lock()


def _kernel(defines: Tuple[str, ...] = ()) -> Tuple[Callable, Callable]:
    """``(fleet_dense_forward, fleet_dense_error_string)`` of the library
    built with ``defines``, their C signatures declared once, at load."""
    fns = _kernels.get(defines)
    if fns is not None:
        return fns
    from . import _build

    with _kernels_lock:
        if defines not in _kernels:
            lib = _build.load("fleet_dense", defines)
            p = ctypes.c_void_p
            forward = lib.fleet_dense_forward
            forward.argtypes = [
                p, p, p, p,                       # X, out, y, mse
                ctypes.c_int,                     # F_y
                p, p, p,                          # indices, scale, offset
                ctypes.c_int, ctypes.c_int,       # M, B
                ctypes.c_int,                     # n_layers
                p, p, p, p,                       # weights, biases, dims, acts
                p,                                # stream
            ]
            forward.restype = ctypes.c_int
            error_string = lib.fleet_dense_error_string
            error_string.argtypes = [ctypes.c_int]
            error_string.restype = ctypes.c_char_p
            _kernels[defines] = (forward, error_string)
        return _kernels[defines]


def _launch(
    spec: FeedForwardSpec,
    stacked: Params,
    X: torch.Tensor,
    indices: Indices,
    ingest: Optional[Tuple[torch.Tensor, torch.Tensor]],
    y: Optional[torch.Tensor],
    defines: Tuple[str, ...],
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``fleet_dense_forward`` on CUDA tensors: K1, or K2 when
    ``y`` is given; returns ``(out, mse or None)``. Never synchronises."""
    if X.device.type != "cuda":
        raise ValueError(f"the fleet_dense kernel runs on cuda or cpu, not {X.device}")
    N = _check(spec, stacked, X, ingest, y)
    M, B, _ = X.shape
    names = spec.layer_names()
    widths = spec.widths()
    if len(names) > MAX_LAYERS or max(widths) > MAX_WIDTH:
        raise ValueError(
            f"spec exceeds the kernel's {MAX_LAYERS} layers / width {MAX_WIDTH}"
        )
    idx = _device_indices(indices, M, N, X.device)
    aliased = y is X
    X = X.contiguous()
    # y passed as X itself stays X, so the narrow kernel reads it from the
    # raw tile in shared memory
    y = X if aliased else (None if y is None else y.contiguous())
    out = torch.empty((M, B, spec.n_features_out), dtype=torch.float32, device=X.device)
    mse = None if y is None else torch.empty((M, B), dtype=torch.float32, device=X.device)
    if M == 0 or B == 0:
        return out, mse
    params = [(stacked[k]["W"].contiguous(), stacked[k]["b"].contiguous()) for k, _ in names]
    scale = offset = None
    if ingest is not None:
        scale, offset = (t.contiguous() for t in ingest)
    n = len(names)
    weights = (ctypes.c_void_p * n)(*[W.data_ptr() for W, _ in params])
    biases = (ctypes.c_void_p * n)(*[b.data_ptr() for _, b in params])
    dims = (ctypes.c_int * (n + 1))(*widths)
    acts = (ctypes.c_int * n)(*[activation_code(a) for _, a in names])
    forward, error_string = _kernel(tuple(defines))
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        status = forward(
            X.data_ptr(),
            out.data_ptr(),
            None if y is None else y.data_ptr(),
            None if mse is None else mse.data_ptr(),
            0 if y is None else y.shape[-1],
            idx.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            offset.data_ptr() if offset is not None else None,
            M,
            B,
            n,
            ctypes.cast(weights, ctypes.c_void_p),
            ctypes.cast(biases, ctypes.c_void_p),
            ctypes.cast(dims, ctypes.c_void_p),
            ctypes.cast(acts, ctypes.c_void_p),
            stream,
        )
    if status != 0:
        message = error_string(status).decode(errors="replace")
        raise RuntimeError(f"fleet_dense kernel launch failed ({status}): {message}")
    return out, mse


def fleet_feedforward(
    spec: FeedForwardSpec,
    stacked: Params,
    X: torch.Tensor,
    indices: Indices = None,
    ingest: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    *,
    defines: Tuple[str, ...] = (),
) -> torch.Tensor:
    """
    Fused fleet forward ``X[M, B, F] -> [M, B, F_out]`` (float32).

    ``stacked`` is a spec bucket (``parallel.fleet.stack_member_params``):
    every leaf carries a leading member axis of size N. ``indices[M]``
    (host ints, default ``0..M-1``, or an integer tensor already on X's
    card, taken without a host round trip and unchecked) picks each batch
    row's member;
    ``ingest`` is the bucket's ``(scale[N, F], offset[N, F])`` plan.
    CUDA tensors launch K1; CPU tensors run the plain version.
    ``defines`` selects a build of the kernel with those preprocessor
    defines, for measurements that compare its variants (``chip_smoke.py``
    times ``FLEET_DENSE_WIDE_ONLY``); serving never passes it.
    """
    if X.device.type == "cpu":
        return fleet_feedforward_reference(spec, stacked, X, indices, ingest)
    out, _ = _launch(spec, stacked, X, indices, ingest, None, defines)
    with _launches_lock:  # request threads of the server launch concurrently
        fleet_feedforward.launches += 1
        fleet_feedforward.shapes[tuple(X.shape)] += 1
    return out


fleet_feedforward.launches = 0  # type: ignore[attr-defined]
fleet_feedforward.shapes = collections.Counter()  # type: ignore[attr-defined]


def fleet_anomaly_scores(
    spec: FeedForwardSpec,
    stacked: Params,
    X: torch.Tensor,
    y: torch.Tensor,
    indices: Indices = None,
    ingest: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    *,
    defines: Tuple[str, ...] = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Fused fleet scoring: ``(reconstruction[M, B, F_out], mse[M, B])``
    (float32), the forward of :func:`fleet_feedforward` and, per row,
    ``mean_j (out[..., j] - y[..., j])**2`` over ``j < min(F_out, F_y)``.

    ``y[M, B, F_y]`` is aligned with ``X`` row for row (it is not gathered
    by ``indices``) and may be ``X`` itself: the error against the raw
    rows, before the ``ingest`` prologue. NaN propagates. CUDA tensors
    launch K2; CPU tensors run the plain version.
    """
    if X.device.type == "cpu":
        return fleet_anomaly_scores_reference(spec, stacked, X, y, indices, ingest)
    out, mse = _launch(spec, stacked, X, indices, ingest, y, defines)
    with _launches_lock:
        fleet_anomaly_scores.launches += 1
    return out, mse


fleet_anomaly_scores.launches = 0  # type: ignore[attr-defined]
