from .ops import wkv6, wkv6_scan_bwd
from .ref import wkv6_bwd_ref, wkv6_chunked_bwd_ref, wkv6_ref
