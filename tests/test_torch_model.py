"""The port's dense forward against ``repro.models.transformer.forward``.

Both packages get the same ``repro.nn.spec.host_initialize`` parameters
(carried bit for bit by ``repro_torch.convert.params_from_numpy``) and the
same numpy tokens.  In float32 the two must agree to rounding
(``atol = rtol = 1e-4``): that checks the algorithm.  In bfloat16 the two
frameworks round matmul outputs and norms at slightly different points,
and the differences compound over the layers; ``BF16_ATOL`` bounds them.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import SMOKES as JAX_SMOKES  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.nn import spec as jax_spec  # noqa: E402
from repro_torch.configs import ARCHS, SMOKES  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import get_family, transformer  # noqa: E402
from repro_torch.nn import spec  # noqa: E402

# bf16 logits are O(1); one bf16 ulp at 2..4 is 1.6e-2, and a flipped
# rounding in an early layer moves a few logits by about two ulps
BF16_ATOL = 3e-2


def _inputs(name, seed=0):
    cfg = JAX_SMOKES[name]
    host = jax_spec.host_initialize(jax_tf.param_specs(cfg), seed=seed)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 32), dtype=np.int32)
    return host, {"tokens": tokens}


def _f32_tree(tree):
    return {k: _f32_tree(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


@pytest.mark.parametrize("name", ["olmo-1b", "qwen2-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(name, dtype):
    """olmo-1b: non-parametric LN and a tied head; qwen2-7b: GQA, qkv bias
    and RMSNorm."""
    host, batch = _inputs(name)
    jcfg = JAX_SMOKES[name]
    cast = jnp.float32 if dtype == "float32" else None
    jparams = jax_spec.map_leaves(
        lambda p, s: jnp.asarray(host[p]).astype(cast or s.dtype),
        jax_tf.param_specs(jcfg))
    want = np.asarray(jax.jit(jax_tf.forward, static_argnums=0)(
        jcfg, jparams, {"tokens": jnp.asarray(batch["tokens"])}), np.float32)

    params = params_from_numpy(host, "cpu")
    if dtype == "float32":
        params = _f32_tree(params)
    got = transformer.forward(SMOKES[name], params, batch)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=BF16_ATOL)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_params_from_numpy_is_bit_exact():
    host, _ = _inputs("qwen2-7b")
    params = params_from_numpy(host, "cpu")
    for path, arr in host.items():
        node = params
        for part in path.split("/"):
            node = node[part]
        if arr.dtype.name == "bfloat16":
            np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                          arr.view(np.int16))
        else:
            np.testing.assert_array_equal(node.numpy(), arr)


def test_host_initialize_matches_jax_bits():
    """The snapshot bytes start here: same RNG law, same bf16 rounding."""
    cfg = SMOKES["qwen2-7b"]
    mine = spec.host_initialize(transformer.param_specs(cfg), seed=5)
    theirs = jax_spec.host_initialize(jax_tf.param_specs(JAX_SMOKES["qwen2-7b"]), seed=5)
    assert mine.keys() == theirs.keys()
    for path, arr in theirs.items():
        assert mine[path].tobytes() == arr.tobytes(), path


@pytest.mark.parametrize("name,item", [("deepseek-moe-16b", "A7"),
                                       ("rwkv6-7b", "A8"), ("pixtral-12b", "A8")])
def test_unported_families_raise_with_roadmap_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        get_family(ARCHS[name])
