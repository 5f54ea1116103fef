"""
The packed fleet fit of ``gordo_tpu/models/packing.py``
(``PackedFeedForwardSpec``, ``auto_packing``, ``unpack_params``,
``build_packed_fit_fn``, ``:84-321``).

The JAX package packs G feedforward members into one block-diagonal
supermodel so that one matmul fills the TPU's 128-lane MXU tile. On the
card the G blocks are exactly the member axis that the stacked fit's
``baddbmm`` already batches, so the block-diagonal matrix is never
materialised: a **pack** is a group of G consecutive members of an
ordinary stacked fit (the last one may hold fewer), and every member
keeps its own ``[d_in, d_out]`` weights, as JAX's compact parameters do.

What packing changes is the training semantics, kept exactly as the JAX
fit has them (``:215-321``):

- each pack shuffles with one permutation an epoch, drawn from its first
  member's fit stream (the caller hands the pack's permutation to each of
  its members);
- each member starts from its own init, the same packed or not;
- the loss is the sum of the members' weighted means, the L1 activity
  penalty counting only for members with data in the batch;
- params and Adam's moments are masked member by member, but the pack
  shares Adam's step count: it advances when any member of the pack has
  data in the batch and stays put when none has, so a member whose batch
  is padding while a packmate's is not moves its count without an update
  (the ragged-bucket divergence the JAX docstring describes, ``:54-58``);
- an epoch's loss is NaN for a member without train weight;
- no early stopping: the trainer falls back to the unpacked fit.

``auto_packing`` keeps JAX's factor, ``128 // widest layer`` capped at
the member count and at 16, because the factor decides which members
share a pack and so the numbers; it is not a tuning for the card.
"""

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import torch

from .spec import FeedForwardSpec, ModelSpec
from .training import FitConfig, FitOutput, StackedFit

#: the TPU MXU's lane width that JAX's packing factor fills
MXU_LANES = 128


@dataclass(frozen=True)
class PackedFeedForwardSpec:
    """G members of ``base`` trained as one pack (the packed program's key)."""

    base: FeedForwardSpec
    g: int


def auto_packing(spec: FeedForwardSpec, n_members: int) -> int:
    """JAX's packing factor: ``128 // widest layer``, capped by the member
    count and at 16.

    >>> from gordo_tpu_torch.models.factories import feedforward_hourglass
    >>> auto_packing(feedforward_hourglass(20), 16), auto_packing(feedforward_hourglass(40), 8)
    (6, 3)
    """
    widest = max((spec.n_features, spec.n_features_out) + tuple(spec.dims))
    g = max(1, MXU_LANES // max(widest, 1))
    return max(1, min(g, n_members, 16))


def unpack_params(packed: Mapping[str, Mapping[str, Any]], spec: PackedFeedForwardSpec, gi: int) -> Dict[str, Dict]:
    """Member ``gi``'s own params of a pack's (leaves ``[G, ...]``)."""
    return {key: {name: leaf[gi] for name, leaf in layer.items()} for key, layer in packed.items()}


class PackedFit(StackedFit):
    """The packed fit of one feedforward spec and config over a stacked
    bucket whose consecutive members form packs of ``g``; trains as
    :meth:`StackedFit.run` does, with the packed semantics above."""

    def __init__(self, spec: ModelSpec, config: FitConfig, g: int):
        if config.early_stopping is not None:
            raise ValueError("Packed training does not support early stopping")
        if not isinstance(spec, FeedForwardSpec):
            raise ValueError(f"Packed training needs a feedforward spec, not {type(spec).__name__}")
        super().__init__(spec, config)
        self.packed = PackedFeedForwardSpec(spec, int(g))
        self._pack_matrix: Optional[torch.Tensor] = None

    def count_mask(self, has_data: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """Each pack's step count advances when any of its members has data
        in the batch (params and moments still move only where a member
        has data)."""
        members = has_data.shape[0]
        if self._pack_matrix is None or self._pack_matrix.shape[0] != members \
                or self._pack_matrix.device != has_data.device:
            packs = torch.arange(members, device=has_data.device) // self.packed.g
            self._pack_matrix = (packs[:, None] == packs[None, :]).float()  # 1 where two members share a pack
        return ((self._pack_matrix @ has_data.float()) > 0) & active

    def _fit(self, params, wtr, wval, batches, validate, callbacks=()) -> FitOutput:
        out = super()._fit(params, wtr, wval, batches, validate, callbacks)
        # a member without train weight has no epoch loss
        out.losses = torch.where((wtr.sum(-1) > 0)[:, None], out.losses, torch.full_like(out.losses, float("nan")))
        return out
