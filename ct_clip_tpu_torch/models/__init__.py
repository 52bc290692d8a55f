from .bert import BertModel
from .ctclip import CTCLIP
from .ctvit import CTViT

__all__ = ["BertModel", "CTCLIP", "CTViT"]
