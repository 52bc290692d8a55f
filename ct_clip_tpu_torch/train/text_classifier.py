"""RadBERT multilabel report classifier: training, inference, evaluation.

Port of ct_clip_tpu/train/text_classifier.py (reference text_classifier/):
RadBertClassifier (RoBERTa pooler -> Linear(768 -> 18)); CSV reports with
optional sentence-shuffle augmentation; the epoch loop with BCEWithLogits,
sigmoid at 0.5, macro/micro F1 and accuracy per epoch, best-loss weights and
early stopping; AdamW 2e-5 with no decay for bias and LayerNorm parameters;
per-epoch CAWR or ReduceLROnPlateau schedules; inference to CSV and the
multilabel report.

The step runs in f32, as the JAX trainer does; f32 matmuls stay true f32
(PyTorch's default "highest" precision, no TF32).  The batches are the JAX
trainer's: the same `random.Random` streams shuffle and augment them.  The
dropout masks come from a `torch.Generator` seeded per step from (seed,
epoch, batch) and cannot match JAX's.  Metrics are numpy
(evals/metrics.py), since the machine with the card has no scikit-learn.
"""
from __future__ import annotations

import csv
import random
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..config import PATHOLOGIES
from ..evals.metrics import (accuracy_score, classification_report, f1_score,
                             multilabel_confusion_matrix)
from ..models.bert import RadBertClassifier
from .finetune import bce_with_logits
from .optimizer import cosine_annealing_warmup_restarts

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def sentence_shuffle(text: str, rng: random.Random, prob: float = 0.5) -> str:
    """TextAugment equivalent (augmentation.py:6-52): with prob, shuffle the
    sentence order."""
    if rng.random() >= prob:
        return text
    sents = [s for s in _SENT_SPLIT.split(text) if s]
    rng.shuffle(sents)
    return " ".join(sents)


class ReportClassificationDataset:
    """CSV of report text + 18 label columns (text_classifier/dataset.py)."""

    def __init__(self, csv_path: str, text_column: str = "report",
                 pathologies: Sequence[str] = PATHOLOGIES,
                 augment_prob: float = 0.0, seed: int = 0):
        self.rows: List[Dict] = []
        self.pathologies = list(pathologies)
        with open(csv_path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                text = row.get(text_column) or row.get("Findings_EN", "")
                labels = np.asarray([float(row.get(p, 0) or 0)
                                     for p in self.pathologies], np.float32)
                self.rows.append({"text": str(text), "labels": labels})
        self.augment_prob = augment_prob
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.rows)

    def batches(self, tokenizer, batch_size: int, max_length: int = 512,
                shuffle: bool = True, augment: bool = False,
                seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.rows)))
        if shuffle:
            random.Random(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            chunk = [self.rows[j] for j in order[i: i + batch_size]]
            texts = [sentence_shuffle(r["text"], self.rng, self.augment_prob)
                     if augment else r["text"] for r in chunk]
            enc = tokenizer(texts, padding="max_length", truncation=True,
                            max_length=max_length)
            yield {"input_ids": np.asarray(enc["input_ids"]),
                   "attention_mask": np.asarray(enc["attention_mask"]),
                   "labels": np.stack([r["labels"] for r in chunk])}


def is_decayed(name: str) -> bool:
    """AdamW decays all but bias and LayerNorm parameters (HF names; the JAX
    package's `no_decay_mask` matches bias, ln_, _ln and layernorm)."""
    name = name.lower()
    return not any(t in name for t in ("bias", "layernorm"))


def param_groups(model: torch.nn.Module, wd: float) -> List[Dict]:
    params = list(model.named_parameters())
    return [{"params": [p for n, p in params if is_decayed(n)], "weight_decay": wd},
            {"params": [p for n, p in params if not is_decayed(n)], "weight_decay": 0.0}]


def _to_device(batch: Dict[str, np.ndarray], device) -> List[torch.Tensor]:
    return [torch.from_numpy(np.asarray(batch[k])).to(device, non_blocking=True)
            for k in ("input_ids", "attention_mask")]


@dataclass
class TextClassifierTrainer:
    model: RadBertClassifier
    tokenizer: object
    lr: float = 2e-5
    wd: float = 0.01
    batch_size: int = 32
    max_epochs: int = 100
    early_stop_patience: int = 100
    threshold: float = 0.5
    seed: int = 0
    # optional per-epoch LR schedule (text_classifier/train.py:126-140;
    # stepped once per epoch like model_trainer.py:66-72):
    #   "cawr" - CosineAnnealingWarmupRestarts over epochs
    #   "rlop" - ReduceLROnPlateau on the monitored (valid) loss
    scheduler: Optional[str] = None
    cawr_first_cycle: int = 200   # train.py:115 cycle_step
    cawr_warmup: int = 50         # train.py:114 w_steps
    cawr_min_lr: float = 2e-7     # train.py:122
    rlop_factor: float = 0.1      # train.py:125
    rlop_patience: int = 25
    rlop_min_lr: float = 2e-6

    history: List[Dict] = field(default_factory=list)

    def __post_init__(self):
        if self.scheduler not in (None, "cawr", "rlop"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        self.device = next(self.model.parameters()).device
        self.optimizer = torch.optim.AdamW(param_groups(self.model, self.wd),
                                           lr=self.lr, betas=(0.9, 0.999),
                                           eps=1e-8)
        self.generator = torch.Generator(device=self.device)
        self._rlop_lr = self.lr
        self._rlop_best = float("inf")
        self._rlop_bad = 0

    def _epoch_lr(self, epoch: int) -> float:
        """LR in effect for this epoch (schedulers advance per epoch)."""
        if self.scheduler == "cawr":
            return float(cosine_annealing_warmup_restarts(
                first_cycle_steps=self.cawr_first_cycle, max_lr=self.lr,
                min_lr=self.cawr_min_lr, warmup_steps=self.cawr_warmup)(epoch))
        if self.scheduler == "rlop":
            return self._rlop_lr
        return self.lr

    def _rlop_step(self, monitored: float) -> None:
        """torch ReduceLROnPlateau(mode='min', factor, patience, min_lr)
        semantics with the default rel threshold 1e-4."""
        if monitored < self._rlop_best * (1.0 - 1e-4):
            self._rlop_best, self._rlop_bad = monitored, 0
        else:
            self._rlop_bad += 1
            if self._rlop_bad > self.rlop_patience:
                self._rlop_lr = max(self._rlop_lr * self.rlop_factor,
                                    self.rlop_min_lr)
                self._rlop_bad = 0

    def train_step(self, batch: Dict[str, np.ndarray], lr: float,
                   step_seed: int = 0) -> torch.Tensor:
        """One AdamW step on a batch at `lr`; returns the loss as a 0-d
        device tensor (no host sync)."""
        self.model.train()
        ids, mask = _to_device(batch, self.device)
        labels = torch.from_numpy(np.asarray(batch["labels"], np.float32)).to(self.device)
        self.generator.manual_seed(step_seed)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        loss = bce_with_logits(self.model(ids, mask, self.generator), labels)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train(self, train_ds: ReportClassificationDataset,
              valid_ds: Optional[ReportClassificationDataset] = None,
              epochs: Optional[int] = None) -> Dict:
        best_loss, best_state, bad_epochs = float("inf"), None, 0
        epochs = epochs or self.max_epochs
        for epoch in range(epochs):
            lr_now = float(np.float32(self._epoch_lr(epoch)))
            losses = [self.train_step(batch, lr_now,
                                      (self.seed << 32) + epoch * 100000 + bi)
                      for bi, batch in enumerate(train_ds.batches(
                          self.tokenizer, self.batch_size, shuffle=True, augment=train_ds.augment_prob > 0,
                          seed=self.seed + epoch))]
            record = {"epoch": epoch,
                      "train_loss": float(np.mean(torch.stack(losses).cpu().numpy())),
                      "lr": lr_now}
            if valid_ds is not None and len(valid_ds):
                probs, labels = self.predict_dataset(valid_ds)
                preds = (probs >= self.threshold).astype(int)
                logits = np.log(np.clip(probs, 1e-7, 1 - 1e-7)
                                / np.clip(1 - probs, 1e-7, 1))
                record.update(
                    valid_loss=float(bce_with_logits(torch.from_numpy(logits),
                                                     torch.from_numpy(labels))),
                    f1_macro=f1_score(labels, preds, average="macro"),
                    f1_micro=f1_score(labels, preds, average="micro"),
                    accuracy=accuracy_score(labels.flatten(), preds.flatten()))
                monitored = record["valid_loss"]
            else:
                monitored = record["train_loss"]
            self.history.append(record)
            if self.scheduler == "rlop":  # stepped on the epoch's test loss
                self._rlop_step(monitored)  # (model_trainer.py:70-72)

            if monitored < best_loss:
                best_loss, bad_epochs = monitored, 0
                best_state = {k: v.detach().clone()
                              for k, v in self.model.state_dict().items()}
            else:
                bad_epochs += 1
                if bad_epochs >= self.early_stop_patience:
                    break
        if best_state is not None:
            self.model.load_state_dict(best_state)
        return {"best_loss": best_loss, "history": self.history}

    @torch.inference_mode()
    def predict_dataset(self, ds: ReportClassificationDataset):
        """Sigmoid probabilities (N, labels) and the labels, in eval mode."""
        self.model.eval()
        probs, labels = [], []
        for batch in ds.batches(self.tokenizer, self.batch_size, shuffle=False):
            ids, mask = _to_device(batch, self.device)
            probs.append(torch.sigmoid(self.model(ids, mask)))
            labels.append(batch["labels"])
        return torch.cat(probs).cpu().numpy(), np.concatenate(labels)

    def infer_to_csv(self, ds: ReportClassificationDataset, out_csv: str):
        """text_classifier/infer.py:94-154: write inferred labels CSV."""
        probs, _ = self.predict_dataset(ds)
        preds = (probs >= self.threshold).astype(int)
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["report"] + list(ds.pathologies))
            for row, pred in zip(ds.rows, preds):
                w.writerow([row["text"]] + pred.tolist())


def multilabel_report(y_true: np.ndarray, y_prob: np.ndarray,
                      pathologies: Sequence[str] = PATHOLOGIES,
                      threshold: float = 0.5) -> Dict:
    """text_classifier/eval.py:8-66: confusion matrices + per-class report."""
    y_pred = (y_prob >= threshold).astype(int)
    return {"confusion": multilabel_confusion_matrix(y_true, y_pred),
            "report": classification_report(y_true, y_pred,
                                            target_names=list(pathologies))}
