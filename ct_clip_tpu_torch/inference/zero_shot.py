"""Zero-shot 18-pathology classification.

Port of ct_clip_tpu/inference/zero_shot.py (volume-input path).  Protocol of
the reference scripts/zero_shot.py:106-171: each pathology's prompt pair
("{p} is present.", "{p} is not present.") is scored against the volume and
softmaxed over the pair; P(present) = probs[0].  As in the JAX package the
36 prompt latents and the CPB bias table are computed once per weight load,
and volumes are encoded in batches, the last batch padded to the batch size.

Artifacts: labels_weights.npz, predicted_weights.npz and accessions.txt.
The AUROC table of the JAX package (evals/metrics.py) needs pandas and
scikit-learn and is not ported yet.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import PATHOLOGIES, PreprocessConfig
from ..data.loader import VolumeLoader
from ..models.ctclip import CTCLIP
from ..ops.resample import preprocess_volume


def pathology_prompts() -> List[str]:
    """36 prompts, ordered [p0 present, p0 absent, p1 present, ...]."""
    out = []
    for p in PATHOLOGIES:
        out.append(f"{p} is present.")
        out.append(f"{p} is not present.")
    return out


class ZeroShotClassifier:
    """Caches the prompt latents and the CPB bias; scores batched volumes."""

    def __init__(self, model: CTCLIP, tokenizer, max_text_len: int = 512):
        self.model = model
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self._prompt_latents: Optional[torch.Tensor] = None
        self._spatial_bias: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.model.temperature.device

    @torch.inference_mode()
    def prompt_latents(self) -> torch.Tensor:
        """(num_pathologies, 2, dim_latent), computed once."""
        if self._prompt_latents is None:
            enc = self.tokenizer(pathology_prompts(),
                                 padding="max_length", truncation=True,
                                 max_length=self.max_text_len)
            ids = torch.as_tensor(enc["input_ids"], dtype=torch.long,
                                  device=self.device)
            mask = torch.as_tensor(enc["attention_mask"], device=self.device)
            lat = self.model.encode_text(ids, mask)
            self._prompt_latents = lat.reshape(len(PATHOLOGIES), 2, -1)
        return self._prompt_latents

    @torch.inference_mode()
    def spatial_bias(self) -> torch.Tensor:
        if self._spatial_bias is None:
            self._spatial_bias = self.model.visual_transformer.compute_spatial_bias()
        return self._spatial_bias

    @torch.inference_mode()
    def scores_from_latents(self, image_latents: torch.Tensor) -> torch.Tensor:
        prompts = self.prompt_latents().float()
        logits = torch.einsum("bd,pkd->bpk", image_latents.float(), prompts)
        logits = logits * self.model.temperature.float().exp()
        return logits.softmax(dim=-1)[..., 0]  # P(present)

    @torch.inference_mode()
    def score_batch(self, videos: torch.Tensor) -> torch.Tensor:
        """(B, f, H, W, 1) preprocessed volumes -> (B, num_pathologies)."""
        latents, _ = self.model.encode_image(videos, self.spatial_bias())
        return self.scores_from_latents(latents)


@torch.inference_mode()
def run_zero_shot(model: CTCLIP, tokenizer, dataset, results_folder: str,
                  batch_size: int = 4, num_workers: int = 8) -> Dict[str, object]:
    """Score every volume of `dataset` on the model's device, write the
    artifacts to `results_folder` and return {"predicted": (N, 18),
    "labels": (N, 18), "accessions": [N]}."""
    clf = ZeroShotClassifier(model, tokenizer)
    vcfg = model.config.ctvit
    pre = PreprocessConfig(
        target_shape=(vcfg.num_frames, vcfg.image_size, vcfg.image_size),
        clip_before_resample=dataset.clip_before_resample)
    loader = VolumeLoader(dataset, num_workers=num_workers,
                          prefetch=2 * batch_size)
    preds: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    names: List[str] = []
    batch: List[torch.Tensor] = []

    def flush():
        n = len(batch)
        vols = batch + [torch.zeros_like(batch[0])] * (batch_size - n)
        probs = clf.score_batch(torch.stack(vols)[..., None])
        preds.append(probs[:n].cpu().numpy())
        batch.clear()

    for sample in loader:
        vol = torch.from_numpy(sample.vol).to(clf.device)
        batch.append(preprocess_volume(
            vol, sample.spacing, float(sample.slope), float(sample.intercept),
            true_sizes=sample.true_sizes_zxy, input_layout="zyx",
            out_dtype=model.dtype, config=pre))
        labels.append(sample.meta.labels)
        names.append(sample.meta.accession)
        if len(batch) == batch_size:
            flush()
    if batch:
        flush()

    n_p = len(PATHOLOGIES)
    predicted = np.concatenate(preds) if preds else np.zeros((0, n_p))
    real = np.stack(labels) if labels else np.zeros((0, n_p))
    out_dir = Path(results_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "labels_weights.npz", data=real)
    np.savez(out_dir / "predicted_weights.npz", data=predicted)
    (out_dir / "accessions.txt").write_text("\n".join(names) + "\n")
    return {"predicted": predicted, "labels": real, "accessions": names}
