"""Shared helpers for the port's hybrid Mamba2 parity tests: the same
seeded tiny hybrid model in both packages."""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import tree_map
from tensorrt_model_optimizer_tpu.models import mamba as jm
from tensorrt_model_optimizer_tpu_torch import convert


def mamba_params_np(cfg, seed: int) -> dict:
    """Seeded f32 weights in the JAX package's per-type stacked layout, the
    norms, A_log, D and dt_bias drawn around their inits."""
    rng = np.random.default_rng(seed)
    h = cfg.hidden_size

    def w(shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    def near(shape, c, s):
        return (c + s * rng.standard_normal(shape)).astype(np.float32)

    shapes = jm._shapes(cfg)
    Lm, La, Lf = cfg.n_blocks(jm.MAMBA), cfg.n_blocks(jm.ATTN), cfg.n_blocks(jm.MLP)
    H = cfg.mamba_num_heads
    p = {"embed_tokens": w((cfg.vocab_size, h), 1), "norm": near((h,), 1, 0.1),
         "lm_head": w((cfg.vocab_size, h), h)}
    if Lm:
        p["layers_mamba"] = {
            "norm": near((Lm, h), 1, 0.1),
            "mixer.in_proj": w((Lm, cfg.d_in_proj, h), h),
            "mixer.out_proj": w((Lm, h, cfg.d_inner), cfg.d_inner),
            "mixer.conv_w": w((Lm, cfg.conv_dim, cfg.conv_kernel), cfg.conv_kernel),
            "mixer.conv_b": near((Lm, cfg.conv_dim), 0, 0.1),
            "mixer.A_log": (np.log(np.arange(1, H + 1, dtype=np.float32))[None] + near((Lm, H), 0, 0.1)),
            "mixer.D": near((Lm, H), 1, 0.1),
            "mixer.dt_bias": near((Lm, H), -2, 0.5),
            "mixer.gnorm": near((Lm, cfg.d_inner), 1, 0.1),
        }
    if La:
        p["layers_attn"] = {"norm": near((La, h), 1, 0.1),
                            **{n: w((La,) + shapes[n], shapes[n][1]) for n in jm.ATTN_NAMES}}
    if Lf:
        p["layers_mlp"] = {"norm": near((Lf, h), 1, 0.1),
                           **{n: w((Lf,) + shapes[n], shapes[n][1]) for n in jm.MLP_NAMES}}
    return p


def mamba_pair(seed: int = 0, **kw):
    """(JAX cfg, JAX params, port cfg, port params) of one seeded tiny model."""
    jcfg = jm.MambaConfig.tiny(**kw)
    pn = mamba_params_np(jcfg, seed)
    return jcfg, tree_map(jnp.asarray, pn), convert.mamba_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pn)


def tokens(seed: int, shape=(2, 24), vocab: int = 256) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)
