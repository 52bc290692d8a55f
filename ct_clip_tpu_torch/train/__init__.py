from .checkpoint import CheckpointManager
from .finetune import bce_with_logits
from .optimizer import (clip_by_global_norm_, cosine_annealing_warmup_restarts,
                        cosine_lr_schedule, get_optimizer)
from .text_classifier import (ReportClassificationDataset, TextClassifierTrainer,
                              multilabel_report, sentence_shuffle)
from .train_step import (TrainState, create_train_state, make_train_step,
                         step_generators)
from .trainer import CTClipTrainer, MetricLogger

__all__ = ["CTClipTrainer", "CheckpointManager", "MetricLogger",
           "ReportClassificationDataset", "TextClassifierTrainer", "TrainState",
           "bce_with_logits", "clip_by_global_norm_", "cosine_annealing_warmup_restarts",
           "cosine_lr_schedule", "create_train_state", "get_optimizer", "make_train_step",
           "multilabel_report", "sentence_shuffle", "step_generators"]
