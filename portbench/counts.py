"""The yardstick: the H100's published peaks and the operations and bytes
that a forward and its kernels' calls need, counted from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), as
``chip_smoke.py`` states them. Counts follow the configuration file
(``configs/<config>.json``), not the program.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}


def bound_s(n_bytes: float, n_ops: float, dtype: str) -> float:
    """The least time for the work: bytes over the HBM rate or operations
    over the peak rate of their type, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[dtype])


def head_dim(conf: dict) -> int:
    return conf.get("head_dim") or conf["d_model"] // conf["n_heads"]


def attention_call(B: int, S: int, H: int, KV: int, D: int, itemsize: int = 2) -> tuple:
    """(bytes, operations) of one causal self-attention call: q, k, v read
    once and the output written once; QK^T and PV over the causal half."""
    n_bytes = (2 * B * S * H * D + 2 * B * S * KV * D) * itemsize
    n_ops = 4 * B * H * D * (S * (S + 1) // 2)
    return n_bytes, n_ops


def attention_shapes(conf: dict, B: int, L: int) -> list:
    """The B3 calls of one forward of a (B, L) batch: (count, shape)."""
    if conf["family"] != "dense":
        raise ValueError(f"unknown family {conf['family']!r}")
    return [(conf["n_layers"], (B, L, conf["n_heads"], conf["n_kv_heads"], head_dim(conf)))]


def attention_bound_s(conf: dict, B: int, L: int) -> float:
    return sum(n * bound_s(*attention_call(*shape), "bfloat16")
               for n, shape in attention_shapes(conf, B, L))


def _attention_block_flops(conf: dict, S: int) -> float:
    """One attention + SwiGLU block over one sequence of S tokens: the
    projections, QK^T and PV over the causal half, and the MLP."""
    d, H, KV, D, f = (conf["d_model"], conf["n_heads"], conf["n_kv_heads"],
                      head_dim(conf), conf["d_ff"])
    linear = 2 * S * (d * H * D + 2 * d * KV * D + H * D * d + 3 * d * f)
    return linear + 2 * H * D * S * (S + 1)


def forward_flops(conf: dict, B: int, L: int) -> float:
    """Model FLOPs of one scoring forward of B sequences of L tokens
    (logits at every position); norms and elementwise work not counted."""
    if conf["family"] != "dense":
        raise ValueError(f"unknown family {conf['family']!r}")
    head = 2 * L * conf["d_model"] * conf["vocab"]
    return B * (conf["n_layers"] * _attention_block_flops(conf, L) + head)
