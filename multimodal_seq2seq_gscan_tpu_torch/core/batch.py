"""Batch contract: one padded batch of gSCAN examples as torch tensors.

A copy of the JAX package's ``core/batch.py`` with torch tensors; sequence
dims are padded to bucketed lengths by ``data/dataset.py``.
"""

from typing import NamedTuple, Union

import torch


class Batch(NamedTuple):
    """One padded batch of gSCAN examples.

    Attributes:
      input_ids:      [B, T_in]  int32, SOS + tokens + EOS, zero-padded.
      input_lengths:  [B]        int32, true lengths incl. SOS/EOS.
      situations:     [B, H, W, C] float32 dense grid (C = object attrs + 1 + 4).
      target_ids:     [B, T_out] int32, SOS + tokens + EOS, zero-padded.
      target_lengths: [B]        int32, true lengths incl. SOS/EOS.
      agent_positions:  [B] int32 flattened row*grid_size+col agent cell.
      target_positions: [B] int32 flattened target-object cell.
    """

    input_ids: torch.Tensor
    input_lengths: torch.Tensor
    situations: torch.Tensor
    target_ids: torch.Tensor
    target_lengths: torch.Tensor
    agent_positions: torch.Tensor
    target_positions: torch.Tensor

    def to(self, device: Union[str, torch.device]) -> "Batch":
        return Batch(*(t.to(device) for t in self))
