from .ops import nonparam_ln, rmsnorm, rope_qk, swiglu
from .ref import nonparam_ln_ref, rmsnorm_ref, rope_ref, swiglu_ref
