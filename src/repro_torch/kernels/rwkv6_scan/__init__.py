from .ops import wkv6
from .ref import wkv6_ref
