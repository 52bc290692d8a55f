from .bert import BertModel, RadBertClassifier
from .ctclip import CTCLIP
from .ctvit import CTViT
from .maskgit import MaskGit, SelfCritic, TokenCritic
from .pipeline import MaskGITPipeline
from .t5_encoder import T5Encoder, T5EncoderConfig, t5_base_v1_1

__all__ = ["BertModel", "CTCLIP", "CTViT", "MaskGITPipeline", "MaskGit", "RadBertClassifier",
           "SelfCritic", "T5Encoder", "T5EncoderConfig", "TokenCritic", "t5_base_v1_1"]
