"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each kernel has the JAX package's three-part form: the kernel itself
(``csrc/<name>.cu``, built by :mod:`.build`), a public wrapper
(``<name>/ops.py``) that runs the plain version on CPU tensors and the
kernel on CUDA tensors, and the plain version (``<name>/ref.py``).  The
elementwise wrappers take CUDA tensors only: ``nn.layers`` picks the
version, since the plain one also serves autograd.
"""
from .build import LAUNCHES, KernelError, build_all, reset_launches
from .decode_attention.ops import gqa_decode
from .elementwise.ops import nonparam_ln, rmsnorm, rope_qk, swiglu
from .flash_attention.ops import mha
from .mamba2_scan.ops import ssd_scan
from .page_gather.ops import gather_pages, scatter_pages
from .rwkv6_scan.ops import wkv6
