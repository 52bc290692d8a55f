"""Masked-language-model auxiliary loss.

Port of ct_clip_tpu/models/mlm.py (reference CT_CLIP/ct_clip/mlm.py): per
row, ceil(mask_prob * seq_len) candidates are drawn among the non-pad
positions and the first ceil(mask_prob * num_valid) of them are masked
(`subset_mask_with_prob`); of the masked positions those whose replacement
draw falls below `replace_prob` (0.9) become the mask token; the text tower
runs again on that sequence (dropout active in training) and `to_logits`
scores the vocabulary; the loss is the cross-entropy over the masked
positions only.

The random draws are tensors, (2, b, n) uniforms on [0, 1): the candidate
scores and the replacement draws, which a generator fills by default
(`MLM.draws`) and a test hands across from the JAX package's keys.  The
head computes in f32, as the JAX package's nn.Dense promotes the bf16
hidden states to its f32 kernel.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def subset_mask_with_prob(valid: torch.Tensor, prob: float,
                          scores: torch.Tensor) -> torch.Tensor:
    """(b, n) bool: per row the `ceil(prob * num_valid)` valid positions with
    the highest `scores`, from the top ceil(prob * n) (mlm.py:18-32)."""
    b, n = valid.shape
    max_masked = math.ceil(prob * n)
    quota = torch.ceil(prob * valid.sum(dim=-1, keepdim=True).float())
    scores = torch.where(valid, scores.float(), torch.full_like(scores.float(), -1e9))
    idx = scores.topk(max_masked, dim=-1).indices
    keep = torch.arange(max_masked, device=valid.device)[None] < quota
    return torch.zeros_like(valid).scatter_(1, idx, keep)


class MLM(nn.Module):
    """The `to_logits` head and the masking objective; `encode_fn(ids, mask)`
    is the text tower (its weights are the CLIP text tower's, not this
    module's)."""

    def __init__(self, dim: int, num_tokens: int, mask_prob: float = 0.15,
                 replace_prob: float = 0.9, mask_token_id: int = 2,
                 pad_token_id: int = 0, device=None):
        super().__init__()
        self.mask_prob, self.replace_prob = mask_prob, replace_prob
        self.mask_token_id, self.pad_token_id = mask_token_id, pad_token_id
        self.to_logits = nn.Linear(dim, num_tokens, device=device)

    @staticmethod
    def draws(b: int, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(2, b, n) f32 uniforms on the CPU: candidate scores, replacement
        draws."""
        return torch.rand((2, b, n), generator=generator)

    def forward(self, seq: torch.Tensor, attention_mask: torch.Tensor,
                encode_fn: Callable, draws: torch.Tensor) -> torch.Tensor:
        scores, replace_u = draws.to(seq.device)
        valid = (seq != self.pad_token_id) & (attention_mask > 0)
        mask = subset_mask_with_prob(valid, self.mask_prob, scores)
        replace = replace_u < self.replace_prob
        masked_seq = torch.where(mask & replace, torch.full_like(seq, self.mask_token_id), seq)
        labels = torch.where(mask, seq, torch.full_like(seq, self.pad_token_id))
        hidden = encode_fn(masked_seq, attention_mask)
        logits = F.linear(hidden.float(), self.to_logits.weight, self.to_logits.bias)
        total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                                ignore_index=self.pad_token_id, reduction="sum")
        return total / (labels != self.pad_token_id).sum().clamp_min(1)
