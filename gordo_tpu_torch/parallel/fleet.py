"""Fleet helpers: the serving half of ``gordo_tpu/parallel/fleet.py``."""

from typing import Any, Dict, Mapping, Sequence

import torch


def stack_member_params(
    members: Sequence[Mapping[str, Mapping[str, Any]]], device: Any = None
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Stack per-member parameter dicts (same keys and shapes) on a leading
    member axis: ``W[d_in, d_out] -> W[N, d_in, d_out]``. Leaves may be
    tensors or numpy arrays; the result is float32 on ``device`` (default:
    the first member's device).

    >>> p = {"out": {"W": torch.ones(2, 3), "b": torch.zeros(3)}}
    >>> tuple(stack_member_params([p, p])["out"]["W"].shape)
    (2, 2, 3)
    """
    if not members:
        raise ValueError("stack_member_params needs at least one member")
    first = members[0]
    stacked: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, layer in first.items():
        stacked[key] = {}
        for name in layer:
            leaves = [torch.as_tensor(m[key][name], dtype=torch.float32) for m in members]
            target = device if device is not None else leaves[0].device
            stacked[key][name] = torch.stack([t.to(target) for t in leaves])
    return stacked
