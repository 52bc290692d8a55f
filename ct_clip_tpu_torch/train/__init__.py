from .checkpoint import CheckpointManager
from .ctvit_trainer import (CTViTTrainer, CTViTTrainState, Discriminator3D, ema_update,
                            group_by_frame_count, hinge_discr_loss, hinge_gen_loss,
                            reconstruct_dataset)
from .finetune import bce_with_logits
from .maskgit_trainer import MaskGitTrainer, MaskGitTrainState, step_generator
from .optimizer import (cawr_schedule, clip_by_global_norm_,
                        cosine_annealing_warmup_restarts, cosine_lr_schedule, get_optimizer)
from .text_classifier import (ReportClassificationDataset, TextClassifierTrainer,
                              multilabel_report, sentence_shuffle)
from .train_step import (TrainState, create_train_state, make_train_step,
                         step_generators)
from .trainer import CTClipTrainer, MetricLogger

__all__ = ["CTClipTrainer", "CTViTTrainState", "CTViTTrainer", "CheckpointManager",
           "Discriminator3D", "MaskGitTrainState", "MaskGitTrainer", "MetricLogger",
           "ReportClassificationDataset", "TextClassifierTrainer", "TrainState",
           "bce_with_logits", "cawr_schedule", "clip_by_global_norm_",
           "cosine_annealing_warmup_restarts", "cosine_lr_schedule", "create_train_state",
           "ema_update", "get_optimizer", "group_by_frame_count", "hinge_discr_loss",
           "hinge_gen_loss", "make_train_step", "multilabel_report", "reconstruct_dataset",
           "sentence_shuffle", "step_generator", "step_generators"]
