from .finetune import bce_with_logits
from .optimizer import cosine_annealing_warmup_restarts
from .text_classifier import (ReportClassificationDataset, TextClassifierTrainer,
                              multilabel_report, sentence_shuffle)

__all__ = ["ReportClassificationDataset", "TextClassifierTrainer",
           "bce_with_logits", "cosine_annealing_warmup_restarts",
           "multilabel_report", "sentence_shuffle"]
