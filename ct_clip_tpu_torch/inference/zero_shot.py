"""Zero-shot 18-pathology classification.

Port of ct_clip_tpu/inference/zero_shot.py.  Protocol of the reference
scripts/zero_shot.py:106-171: each pathology's prompt pair ("{p} is
present.", "{p} is not present.") is scored against the volume and softmaxed
over the pair; P(present) = probs[0].  As in the JAX package the 36 prompt
latents and the CPB bias table are computed once per weight load, and
volumes are encoded in batches of a fixed size.

Two ingest routes, as in the JAX package:
  * patch rows (the default on CUDA): each volume is preprocessed and moved
    into patch rows by K6 straight into its slot of one (B, t*h*w,
    patch_dim) batch buffer, and the tower embeds the rows with K4;
  * volumes (the default on the CPU): each preprocessed volume is stacked
    into a (B, f, H, W, 1) batch and embedded with K8.
The tail batch is scored at the full batch size and only its real rows are
kept.

Artifacts: labels_weights.npz, predicted_weights.npz, accessions.txt and the
per-pathology AUROC table aurocs.csv (evals/metrics.py).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import PATHOLOGIES, PreprocessConfig
from ..data.loader import VolumeLoader
from ..evals.metrics import evaluate_internal, write_table
from ..models.ctclip import CTCLIP
from ..ops.resample import preprocess_rows_into, preprocess_volume


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
        """(B, f, H, W, 1) preprocessed volumes or (B, t*h*w, patch_dim)
        patch rows -> (B, num_pathologies)."""
        latents, _ = self.model.encode_image(videos, self.spatial_bias())
        return self.scores_from_latents(latents)


@torch.inference_mode()
def run_zero_shot(model: CTCLIP, tokenizer, dataset, results_folder: str,
                  batch_size: int = 4, num_workers: int = 8,
                  patch_rows: Optional[bool] = None) -> Dict[str, object]:
    """Score every volume of `dataset` on the model's device, write the
    artifacts to `results_folder` and return {"predicted": (N, 18),
    "labels": (N, 18), "accessions": [N]}.  `patch_rows` picks the ingest
    route; None means patch rows when the model is on CUDA."""
    clf = ZeroShotClassifier(model, tokenizer)
    if patch_rows is None:
        patch_rows = clf.device.type == "cuda"
    vcfg = model.config.ctvit
    pre = PreprocessConfig(
        target_shape=(vcfg.num_frames, vcfg.image_size, vcfg.image_size),
        clip_before_resample=dataset.clip_before_resample)
    loader = VolumeLoader(dataset, num_workers=num_workers,
                          prefetch=2 * batch_size)
    preds: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    names: List[str] = []
    pending = 0  # volumes in the batch not yet scored
    if patch_rows:
        # one buffer: the stream orders each slot write after the previous
        # batch's score, and a tail batch's unwritten slots keep the previous
        # batch's rows, which are scored and dropped
        n_tok = vcfg.patch_t * vcfg.patch_hw ** 2
        buf = torch.zeros((batch_size, n_tok, vcfg.patch_dim),
                          dtype=model.dtype, device=clf.device)
    else:
        vols: List[torch.Tensor] = []

    def flush():
        nonlocal pending
        if patch_rows:
            videos = buf
        else:
            pad = [torch.zeros_like(vols[0])] * (batch_size - pending)
            videos = torch.stack(vols + pad)[..., None]
            vols.clear()
        preds.append(clf.score_batch(videos)[:pending].cpu().numpy())
        pending = 0

    for sample in loader:
        vol = torch.from_numpy(sample.vol).to(clf.device)
        args = (vol, sample.spacing, float(sample.slope), float(sample.intercept))
        kw = dict(true_sizes=sample.true_sizes_zxy, input_layout="zyx", config=pre)
        if patch_rows:
            preprocess_rows_into(buf, pending, *args, **kw,
                                 temporal_patch_size=vcfg.temporal_patch_size,
                                 patch_size=vcfg.patch_size)
        else:
            vols.append(preprocess_volume(*args, **kw, out_dtype=model.dtype))
        labels.append(sample.meta.labels)
        names.append(sample.meta.accession)
        pending += 1
        if pending == batch_size:
            flush()
    if pending:
        flush()

    n_p = len(PATHOLOGIES)
    predicted = np.concatenate(preds) if preds else np.zeros((0, n_p))
    real = np.stack(labels) if labels else np.zeros((0, n_p))
    out_dir = Path(results_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "labels_weights.npz", data=real)
    np.savez(out_dir / "predicted_weights.npz", data=predicted)
    (out_dir / "accessions.txt").write_text("\n".join(names) + "\n")
    write_table(evaluate_internal(predicted, real, PATHOLOGIES),
                out_dir / "aurocs.csv")
    return {"predicted": predicted, "labels": real, "accessions": names}
