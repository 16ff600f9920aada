"""Shared helpers for the port's diffusion parity tests: the same seeded tiny
DiT in both packages, with the tensors JAX's adaLN-zero init leaves at zero
(`adaLN.mod`, `final_mod`, `final_proj`, every bias) made random, since on
zeros every comparison would read 0 = 0."""

import jax
import jax.numpy as jnp
import numpy as np

from tensorrt_model_optimizer_tpu.models import dit as jdit
from tensorrt_model_optimizer_tpu_torch import convert

# hidden 128: fc2's K (512) and the others' (128) are whole INT4 blocks
DIT_SIZE = dict(img_size=16, patch_size=2, hidden_size=128, depth=2, num_heads=4)


def randomized(params: dict, seed: int) -> dict:
    """A DiT parameter tree (numpy) with the zero-initialised tensors drawn
    from N(0, 0.05^2) (biases N(0, 0.1^2))."""
    rng = np.random.default_rng(seed)
    p = {k: v for k, v in params.items()}
    p["blocks"] = dict(params["blocks"])
    for k in ("final_mod", "final_proj"):
        p[k] = (0.05 * rng.standard_normal(p[k].shape)).astype(np.float32)
    p["blocks"]["adaLN.mod"] = (0.05 * rng.standard_normal(p["blocks"]["adaLN.mod"].shape)).astype(np.float32)
    for k in p["blocks"]:
        if k.endswith("__bias"):
            p["blocks"][k] = (0.1 * rng.standard_normal(p["blocks"][k].shape)).astype(np.float32)
    return p


def dit_pair(seed: int = 0, **kw):
    """(JAX config, JAX params, port config, port params) of a tiny f32 DiT:
    JAX's init from PRNGKey(seed), its zeros made random, the same values in
    both packages."""
    jcfg = jdit.DiTConfig.tiny(**{**DIT_SIZE, **kw})
    p = randomized(jax.tree.map(np.asarray, jdit.init_params(jcfg, jax.random.PRNGKey(seed))), seed + 100)
    return jcfg, jax.tree.map(jnp.asarray, p), convert.dit_cfg_from_jax(jcfg), convert.params_from_jax(p)


def latents(cfg, n: int, seed: int):
    """n seeded (x [2, H, W, C] f32, t [2] int32) pairs."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32),
             rng.integers(0, 1000, size=(2,)).astype(np.int32)) for _ in range(n)]
