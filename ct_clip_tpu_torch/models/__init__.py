from .bert import BertModel, RadBertClassifier
from .ctclip import CTCLIP
from .ctvit import CTViT

__all__ = ["BertModel", "CTCLIP", "CTViT", "RadBertClassifier"]
