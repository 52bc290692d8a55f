"""Fine-tuning losses (port of ct_clip_tpu/train/finetune.py; the VocabFine
and LiPro heads are not ported yet)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    pos_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch BCEWithLogitsLoss(pos_weight=...) semantics, mean reduction,
    written as the JAX package writes it (log-sigmoid of both signs)."""
    w_pos = 1.0 if pos_weight is None else pos_weight
    loss = -(w_pos * labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))
    return loss.mean()
