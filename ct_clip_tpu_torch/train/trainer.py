"""CTClipTrainer: the CT-CLIP contrastive pretraining loop.

Port of ct_clip_tpu/train/trainer.py (:39-374; reference
scripts/CTCLIPTrainer.py:113-348) on one card: infinite shuffled batches,
reports tokenised to 512, the step of train_step.py (clip 0.5, Adam at the
constant lr 1.25e-6), metrics streamed to `metrics.jsonl`, a mini zero-shot
evaluation on a few validation volumes every `save_results_every` steps
(AUROC table `mini_eval_step{n}.csv`), a checkpoint every `save_model_every`
steps and automatic resume from the latest one.

Ingest: on CUDA the volumes go in as patch rows, as the JAX trainer's on its
accelerator (trainer.py:96-100): each volume is preprocessed on the card
and K6 writes its rows straight into its slot of the one batch buffer (the
stream orders each slot write after the previous step's reads).  On the CPU
the preprocessed volumes are stacked.  Orbax checkpoints, the mesh and
multi-host loading are not ported.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..config import PATHOLOGIES, PreprocessConfig, TrainConfig
from ..data.datasets import CTReportDataset, CTReportDatasetInfer
from ..data.loader import VolumeLoader
from ..evals.metrics import evaluate_internal, write_table
from ..inference.zero_shot import ZeroShotClassifier
from ..models.ctclip import CTCLIP
from ..ops.resample import preprocess_rows_into, preprocess_volume
from .checkpoint import CheckpointManager
from .train_step import TrainState, create_train_state, make_train_step


class MetricLogger:
    """JSONL metrics stream plus stdout (ct_clip_tpu/train/trainer.py:39-59)."""

    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time(), **metrics}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        msg = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in metrics.items())
        print(f"step {step}: {msg}", flush=True)


class CTClipTrainer:
    def __init__(self, model: CTCLIP, tokenizer, *, train_dataset: CTReportDataset,
                 valid_dataset: Optional[CTReportDatasetInfer] = None,
                 config: TrainConfig = TrainConfig(), results_folder: str = "./results",
                 num_workers: int = 8):
        if config.remat:
            raise NotImplementedError("remat: the fused sublayers already recompute "
                                      "from their input; nothing else is ported")
        self.model = model
        self.tokenizer = tokenizer
        self.cfg = config
        self.train_ds = train_dataset
        self.valid_ds = valid_dataset
        self.device = model.temperature.device
        self.patch_rows = self.device.type == "cuda"
        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.num_workers = num_workers
        self.state: TrainState = create_train_state(model, config)
        self.step_fn = make_train_step(config)
        self.logger = MetricLogger(self.results_folder / "metrics.jsonl")
        self.ckpt = CheckpointManager(self.results_folder / "checkpoints")
        vcfg = model.config.ctvit

        def pre(ds):
            return PreprocessConfig(
                target_shape=(vcfg.num_frames, vcfg.image_size, vcfg.image_size),
                clip_before_resample=ds.clip_before_resample)
        self._pre = pre

    # ------------------------------------------------------------------ data
    def _tokens(self, texts) -> Dict[str, torch.Tensor]:
        enc = self.tokenizer(texts, padding="max_length", truncation=True, max_length=512)
        return {k: torch.as_tensor(enc[k], dtype=torch.long, device=self.device)
                for k in ("input_ids", "attention_mask")}

    def _ingest(self, sample, pre: PreprocessConfig, buf=None, slot: int = 0):
        """One volume onto the device: into `buf[slot]` as patch rows, or as
        a (f, H, W, 1) volume in the model's dtype."""
        vcfg = self.model.config.ctvit
        vol = torch.from_numpy(sample.vol).to(self.device)
        args = (vol, sample.spacing, float(sample.slope), float(sample.intercept))
        kw = dict(true_sizes=sample.true_sizes_zxy, input_layout="zyx", config=pre)
        if buf is not None:
            return preprocess_rows_into(buf, slot, *args, **kw,
                                        temporal_patch_size=vcfg.temporal_patch_size,
                                        patch_size=vcfg.patch_size)
        return preprocess_volume(*args, **kw, out_dtype=self.model.dtype)[..., None]

    def _batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Infinite batches: host read -> device preprocess -> batch."""
        bs, vcfg = self.cfg.batch_size, self.model.config.ctvit
        loader = VolumeLoader(self.train_ds, num_workers=self.num_workers,
                              prefetch=2 * bs, shuffle=True, infinite=True,
                              seed=self.cfg.seed)
        pre = self._pre(self.train_ds)
        buf = None
        if self.patch_rows:
            buf = torch.zeros((bs, vcfg.patch_t * vcfg.patch_hw ** 2, vcfg.patch_dim),
                              dtype=self.model.dtype, device=self.device)
        vols, texts = [], []
        for sample in loader:
            if buf is not None:
                self._ingest(sample, pre, buf, len(texts))
            else:
                vols.append(self._ingest(sample, pre))
            texts.append(sample.meta.text)
            if len(texts) == bs:
                video = buf if buf is not None else torch.stack(vols)
                yield {"video": video, **self._tokens(texts)}
                vols, texts = [], []

    # ----------------------------------------------------------------- train
    def load(self, step: Optional[int] = None) -> int:
        self.ckpt.restore(self.state, step)
        return self.state.step

    def train(self, num_steps: Optional[int] = None, auto_resume: bool = True) -> TrainState:
        """Runs the loop to `num_steps` (the config's by default).  With
        auto_resume, training continues from the latest checkpoint under the
        results folder, if there is one."""
        num_steps = num_steps or self.cfg.num_train_steps
        if auto_resume and self.ckpt.latest_step is not None \
                and self.ckpt.latest_step > self.state.step:
            self.load()
            self.logger.log(self.state.step, resumed_from=self.state.step)
        if self.state.step >= num_steps:
            return self.state
        t_last = time.time()
        for batch in self._batches():
            step = self.state.step
            gen = torch.Generator(device=self.device).manual_seed(
                self.cfg.seed * 1_000_003 + step)
            metrics = self.step_fn(self.state, batch, gen)
            now = time.time()
            self.logger.log(step, loss=float(metrics["loss"]),
                            grad_norm=float(metrics["grad_norm"]),
                            temperature=float(metrics["temperature"]),
                            step_time=now - t_last)
            t_last = now
            next_step = step + 1
            if next_step % self.cfg.save_results_every == 0:
                self._mini_eval(next_step)
            if next_step % self.cfg.save_model_every == 0:
                self.ckpt.save(next_step, self.state)
            if next_step >= num_steps:
                break
        return self.state

    # ------------------------------------------------------------------ eval
    def _mini_eval(self, step: int, num_volumes: int = 10) -> Optional[float]:
        """Zero-shot AUROC on up to `num_volumes` validation volumes
        (CTCLIPTrainer.py:266-327), one volume per scored batch."""
        if self.valid_ds is None or len(self.valid_ds) == 0:
            return None
        self.model.eval()
        clf = ZeroShotClassifier(self.model, self.tokenizer)  # prompts of these weights
        pre, vcfg = self._pre(self.valid_ds), self.model.config.ctvit
        buf = None
        if self.patch_rows:
            buf = torch.zeros((1, vcfg.patch_t * vcfg.patch_hw ** 2, vcfg.patch_dim),
                              dtype=self.model.dtype, device=self.device)
        preds, labels = [], []
        loader = VolumeLoader(self.valid_ds, num_workers=self.num_workers, prefetch=4)
        for i, sample in enumerate(loader):
            if i >= num_volumes:
                break
            video = (self._ingest(sample, pre, buf, 0) if buf is not None
                     else self._ingest(sample, pre)[None])
            preds.append(clf.score_batch(video)[0].float().cpu().numpy())
            labels.append(sample.meta.labels)
        table = evaluate_internal(np.stack(preds), np.stack(labels), PATHOLOGIES)
        write_table(table, self.results_folder / f"mini_eval_step{step}.csv")
        self.logger.log(step, mini_eval_mean_auc=float(table["mean_auc"]))
        return float(table["mean_auc"])
