"""Latent export: for each volume, the text latent of its report and the
encoded, quantized token grid of the image tower (the reference's
`enc_image_send`, ct_clip.py:722,792), saved as npz under
results/{text_latents,image_latents}/<accession>.npz (key "arr", float32).

Port of ct_clip_tpu/inference/latents.py::export_latents (reference
scripts/forward_data.py:114-151).  As there, volumes take the volume route
(K8), one at a time.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..config import PreprocessConfig
from ..data.loader import VolumeLoader
from ..models.ctclip import CTCLIP
from ..ops.resample import preprocess_volume


@torch.inference_mode()
def export_latents(model: CTCLIP, tokenizer, dataset, results_folder: str,
                   num_workers: int = 8,
                   max_text_len: int = 512) -> Dict[str, Dict[str, np.ndarray]]:
    """Write one image and one text npz per volume of `dataset` and return
    {"text": {acc: (dim_latent,)}, "image": {acc: (t, h, w, dim)}}."""
    out_dir = Path(results_folder)
    (out_dir / "image_latents").mkdir(parents=True, exist_ok=True)
    (out_dir / "text_latents").mkdir(parents=True, exist_ok=True)
    device = model.temperature.device
    vcfg = model.config.ctvit
    pre = PreprocessConfig(
        target_shape=(vcfg.num_frames, vcfg.image_size, vcfg.image_size),
        clip_before_resample=dataset.clip_before_resample)
    spatial_bias = model.visual_transformer.compute_spatial_bias()

    texts, images = {}, {}
    for sample in VolumeLoader(dataset, num_workers=num_workers, prefetch=4):
        vol = preprocess_volume(
            torch.from_numpy(sample.vol).to(device), sample.spacing,
            float(sample.slope), float(sample.intercept),
            true_sizes=sample.true_sizes_zxy, input_layout="zyx",
            out_dtype=model.dtype, config=pre)
        grid = model.visual_transformer(vol[None, ..., None], spatial_bias)
        enc = tokenizer([sample.meta.text], padding="max_length",
                        truncation=True, max_length=max_text_len)
        ids = torch.as_tensor(enc["input_ids"], dtype=torch.long, device=device)
        mask = torch.as_tensor(enc["attention_mask"], device=device)
        text = model.encode_text(ids, mask)
        acc = sample.meta.accession
        image_arr = grid[0].float().cpu().numpy()
        text_arr = text[0].float().cpu().numpy()
        np.savez(out_dir / "image_latents" / f"{acc}.npz", arr=image_arr)
        np.savez(out_dir / "text_latents" / f"{acc}.npz", arr=text_arr)
        texts[acc], images[acc] = text_arr, image_arr
    return {"text": texts, "image": images}
