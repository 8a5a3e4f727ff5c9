"""Plain reference of the dense family (OLMo-style decoder), one sequence
at a time, from arXiv:2402.00838's description: token embedding; per
layer a pre-norm causal self-attention with rotary embedding and a
pre-norm SwiGLU MLP, each added to the residual; a final norm; the head
(the embedding table itself when tied). The norm is non-parametric layer
norm (``norm: nonparam_ln``) or RMSNorm with a scale.

Parameters are keyed by path (``layers/attn/wq`` stacked over layers,
``embed/table``, ...) as the benchmark drew them; everything runs in
float32 (or in the control's precision, ``common.mm``).
"""
from __future__ import annotations

import torch

from .common import attention_block, layernorm, mm, rmsnorm, sub, swiglu, weight


def _norm(conf: dict, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    if conf["norm"] == "nonparam_ln":
        return layernorm(x)
    return rmsnorm(x, p[f"{name}/scale"])


def forward(conf: dict, params: dict, tokens: torch.Tensor, *,
            precision: str = "f32") -> torch.Tensor:
    """Logits (S, vocab) of one sequence of token ids (S,)."""
    table = weight(params["embed/table"], precision)
    x = table[tokens]
    for i in range(conf["n_layers"]):
        p = sub(params, "layers", i)
        x = x + attention_block(sub(p, "attn"), _norm(conf, p, "ln1", x),
                                conf["rope_theta"], precision)
        x = x + swiglu(sub(p, "mlp"), _norm(conf, p, "ln2", x), precision)
    x = _norm(conf, params, "ln_f", x)
    if conf["tied_embeddings"]:
        return mm(x, table.T, precision)
    return mm(x, params["lm_head/w"], precision)
