from .ops import gqa_decode
from .ref import decode_attention_ref, gqa_decode_ref
