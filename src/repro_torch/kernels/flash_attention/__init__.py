from .ops import mha
from .ref import flash_attention_ref, mha_ref
