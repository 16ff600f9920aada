"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
seeded numpy inputs handed to both the JAX package and the PyTorch port."""

import numpy as np
import pytest
import torch

# The parity tests run beside JAX under pytest-xdist workers; one intra-op
# thread per worker keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)


def llama_params_np(cfg, seed: int) -> dict:
    """Seeded f32 weights in the JAX package's stacked [L, out, in] layout."""
    rng = np.random.default_rng(seed)
    L, h, hd = cfg.num_hidden_layers, cfg.hidden_size, cfg.hd
    shapes = {
        "self_attn.q_proj": (cfg.num_attention_heads * hd, h),
        "self_attn.k_proj": (cfg.num_key_value_heads * hd, h),
        "self_attn.v_proj": (cfg.num_key_value_heads * hd, h),
        "self_attn.o_proj": (h, cfg.num_attention_heads * hd),
        "mlp.gate_proj": (cfg.intermediate_size, h),
        "mlp.up_proj": (cfg.intermediate_size, h),
        "mlp.down_proj": (h, cfg.intermediate_size),
    }
    layers = {name: (rng.standard_normal((L, o, i)) / np.sqrt(i)).astype(np.float32)
              for name, (o, i) in shapes.items()}
    layers["input_layernorm"] = (1 + 0.1 * rng.standard_normal((L, h))).astype(np.float32)
    layers["post_attention_layernorm"] = (1 + 0.1 * rng.standard_normal((L, h))).astype(np.float32)
    return {
        "embed_tokens": rng.standard_normal((cfg.vocab_size, h)).astype(np.float32),
        "layers": layers,
        "norm": (1 + 0.1 * rng.standard_normal(h)).astype(np.float32),
        "lm_head": (rng.standard_normal((cfg.vocab_size, h)) / np.sqrt(h)).astype(np.float32),
    }


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's CUDA kernels build and run only there")
    return torch.device("cuda")
