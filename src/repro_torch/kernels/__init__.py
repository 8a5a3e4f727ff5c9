"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each kernel has the JAX package's three-part form: the kernel itself
(``csrc/<name>.cu``, built by :mod:`.build`), a public wrapper
(``<name>/ops.py``) that runs the plain version on CPU tensors and the
kernel on CUDA tensors, and the plain version (``<name>/ref.py``).
"""
from .build import LAUNCHES, KernelError, build_all, reset_launches
from .flash_attention.ops import mha
from .page_gather.ops import gather_pages, scatter_pages
