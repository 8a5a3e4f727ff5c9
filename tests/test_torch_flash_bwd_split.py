"""The arithmetic of B3's bfloat16 backward on the tensor cores, modelled in
plain torch on the CPU (``csrc/flash_attention.cu``, the ``_bf16`` backward
kernels, run only on the card).

The kernels take S = Q K^T and dP = dO V^T from bfloat16 inputs with
float32 sums, form P and dS = P (dP - delta) in float32, and feed each of P
and dS to dV = P^T dO, dK = dS^T Q and dQ = dS K as the sum of
``PARTS`` bfloat16 parts, each the bfloat16 rounding of what the parts
before it leave; every output is rounded once to bfloat16.  The model
below does the same without tiles (the kernels' tiles only change the
order of the float32 sums), and is held to the float32 oracle
``flash_attention_bwd_ref`` within the chip gate's four bfloat16 ulps at
each output's largest magnitude (``chip_smoke.KERNEL_ULPS``).  The model
lives here: nothing on the port's path runs it.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref, mha_lse_ref,
                                                     mha_ref)

PARTS = 3                    # kPParts in csrc/flash_attention.cu
KERNEL_ULPS = 4              # chip_smoke.py's gate on the backward's bf16 outputs
LOG2E = 1.4426950408889634


def bf16_parts(x: torch.Tensor, parts: int = PARTS) -> list[torch.Tensor]:
    """float32 ``x`` as ``parts`` bfloat16 tensors, each the round-to-nearest
    bfloat16 of what the parts before it leave."""
    out, rest = [], x
    for _ in range(parts):
        part = rest.to(torch.bfloat16)
        out.append(part)
        rest = rest - part.float()
    return out


def split_einsum(eq: str, a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """``einsum(eq, a, b)`` with float32 ``a`` entering as its bfloat16 parts
    and bfloat16 ``b``: each part's products are exact, summed in float32."""
    return sum(torch.einsum(eq, part.float(), b.float()) for part in bf16_parts(a, parts))


def model_bwd(q, k, v, o, lse, do, causal: bool, parts: int = PARTS):
    """dq, dk, dv (bfloat16) as the tensor-core route computes them."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, KV, G, D)
    dog = do.reshape(B, S, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog.float(), v.float())
    # P = exp2(S scale log2(e) - lse log2(e)), the masked pairs 0
    lse2 = (lse.reshape(B, KV, G, S) * LOG2E)[..., None]
    p = torch.exp2(s * (scale * LOG2E) - lse2)
    if causal:
        p = p * torch.tril(torch.ones(S, S, dtype=torch.bool))
    delta = torch.sum(dog.float() * o.reshape(B, S, KV, G, D).float(), dim=-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dv = split_einsum("bkgqs,bqkgd->bskd", p, dog, parts)
    dk = split_einsum("bkgqs,bqkgd->bskd", ds, qg, parts) * scale
    dq = split_einsum("bkgqs,bskd->bqkgd", ds, k, parts) * scale
    return (dq.reshape(B, S, H, D).to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16))


def bf16_inputs(B, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
    return r(B, S, H, D), r(B, S, KV, D), r(B, S, KV, D), r(B, S, H, D)


@pytest.mark.parametrize("B,S,H,KV,D,causal", [
    (2, 96, 4, 2, 32, True),        # GQA, causal, a ragged length
    (1, 80, 6, 2, 80, True),        # D = 80, G = 3
    (2, 72, 4, 4, 64, False),       # bidirectional (an encoder's)
])
def test_split_route_within_the_chip_gate(B, S, H, KV, D, causal):
    """The modelled route against the float32 oracle on the same bfloat16
    inputs, output and LSE: within four bfloat16 ulps at each output's
    largest magnitude, as ``chip_smoke.check_flash_bwd`` holds the kernel."""
    q, k, v, do = bf16_inputs(B, S, H, KV, D, seed=S + D)
    o = mha_ref(q, k, v, causal=causal)
    lse = mha_lse_ref(q, k, causal=causal)
    got = model_bwd(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        m = float(w.abs().max())
        atol = KERNEL_ULPS * 2.0 ** (math.floor(math.log2(m)) - 7)
        err = float((g.float() - w).abs().max())
        assert err <= atol, (name, err, atol)


def test_three_parts_keep_float32_precision():
    """Three bfloat16 parts sum to a normal float32 value within 2^-22 of its
    magnitude (8 bits a part, float32's 24 and more); two parts (16 bits)
    do not, which is why P and dS take three."""
    rng = np.random.default_rng(0)
    mant = rng.uniform(1.0, 2.0, 100_000)
    expo = rng.integers(-100, 100, 100_000)
    sign = rng.choice([-1.0, 1.0], 100_000)
    x = torch.from_numpy((sign * mant * 2.0 ** expo).astype(np.float32))
    xd = x.double()

    def rel_err(parts):
        total = sum(p.double() for p in bf16_parts(x, parts))
        return ((total - xd).abs() / xd.abs()).max().item()
    assert rel_err(3) <= 2.0 ** -22
    assert rel_err(2) > 2.0 ** -22
    # each part is the rounding of what the parts before it leave
    hi, mid, lo = bf16_parts(x)
    assert torch.equal(hi, x.to(torch.bfloat16))
    assert torch.equal(mid, (x - hi.float()).to(torch.bfloat16))
    assert torch.equal(lo, (x - hi.float() - mid.float()).to(torch.bfloat16))


def test_one_bf16_part_is_coarser_than_three():
    """A single bfloat16 P and dS (the TPU kernel's rounding of P) moves the
    outputs farther from the oracle than three parts do."""
    q, k, v, do = bf16_inputs(2, 96, 4, 2, 32, seed=1)
    o = mha_ref(q, k, v)
    lse = mha_lse_ref(q, k)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, True)
    errs = {}
    for parts in (1, PARTS):
        got = model_bwd(q, k, v, o, lse, do, True, parts)
        errs[parts] = sum(float((g.float() - w).abs().max()) for g, w in zip(got, want))
    assert errs[PARTS] < errs[1], errs
