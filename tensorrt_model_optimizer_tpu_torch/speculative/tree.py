"""Tree attention for speculative decoding (port of `speculative/tree.py`).

Several candidate continuations are verified in one base-model forward by
laying the tree out as extra sequence positions under a tree-shaped
attention mask: each draft token attends to the prompt and to its tree
ancestors only. The topology (parents, depths, the node mask) is static and
lives on the host in numpy; the masks and position ids are tensors on the
caller's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models import llama

# The default candidate tree (a small Medusa-style tree: head 0's top-2,
# head 1's top-2 under head 0's best pick, one depth-3 chain).
DEFAULT_TREE_PATHS = [[0], [1], [0, 0], [0, 1], [1, 0], [0, 0, 0]]


@dataclasses.dataclass(frozen=True)
class Tree:
    """Static tree topology. Node 0 is the base token (the model's own
    next-token pick); nodes 1.. are draft candidates in BFS order."""

    n_nodes: int
    parent: tuple[int, ...]  # parent node index per node (node 0 -> -1)
    depth: tuple[int, ...]  # 0 for the base token
    choice: tuple[int, ...]  # which top-k child of the parent (by path digit)
    attn_mask: np.ndarray  # [N, N] bool, True = may attend

    @property
    def max_depth(self) -> int:
        return max(self.depth)

    def children(self, idx: int) -> list[int]:
        return [i for i, p in enumerate(self.parent) if p == idx]


def build_tree(tree_paths: Optional[list] = None) -> Tree:
    """BFS-ordered tree from reference-style paths (each a list of top-k
    digits, one per depth)."""
    paths = sorted(tree_paths or DEFAULT_TREE_PATHS)
    node_paths = sorted({tuple(p) for p in paths}, key=lambda p: (len(p), p))
    for p in node_paths:
        if len(p) > 1 and p[:-1] not in node_paths:
            raise ValueError(f"incomplete tree path {p}")
    index = {(): 0}
    for i, p in enumerate(node_paths):
        index[p] = i + 1
    n = len(node_paths) + 1
    parent = [-1] + [index[p[:-1]] for p in node_paths]
    depth = [0] + [len(p) for p in node_paths]
    choice = [0] + [p[-1] for p in node_paths]
    mask = np.zeros((n, n), dtype=bool)
    for i in range(n):
        j = i
        while j >= 0:  # self and every ancestor
            mask[i, j] = True
            j = parent[j]
    return Tree(n, tuple(parent), tuple(depth), tuple(choice), mask)


def tree_attention_mask(tree: Tree, prompt_len: int, device=None) -> torch.Tensor:
    """Additive mask [1, 1, P+N, P+N] (0 / -1e9, f32) for [prompt || tree]
    verification: the prompt part causal, the tree rows on the whole prompt
    and their ancestors."""
    P, N = prompt_len, tree.n_nodes
    allow = np.zeros((P + N, P + N), dtype=bool)
    allow[:P, :P] = np.tril(np.ones((P, P), dtype=bool))
    allow[P:, :P] = True
    allow[P:, P:] = tree.attn_mask
    return torch.from_numpy(np.where(allow, 0.0, -1e9).astype(np.float32)).to(device)[None, None]


def tree_position_ids(tree: Tree, prompt_len: int, device=None) -> torch.Tensor:
    """[1, P+N] int32 position ids: the prompt 0..P-1, a node at depth d at P+d."""
    pos = list(range(prompt_len)) + [prompt_len + d for d in tree.depth]
    return torch.tensor(pos, dtype=torch.int32, device=device)[None, :]


def assemble_candidates(tree: Tree, base_token: int, head_topk: np.ndarray) -> np.ndarray:
    """Token per node. `head_topk` [n_heads, k]: head d-1's top-k picks; a
    node at depth d with path digit c takes head_topk[d-1, c]."""
    toks = np.zeros((tree.n_nodes,), np.int32)
    toks[0] = base_token
    for i in range(1, tree.n_nodes):
        toks[i] = head_topk[tree.depth[i] - 1, tree.choice[i]]
    return toks


def accept_nodes(tree: Tree, tokens: np.ndarray, verify_argmax: np.ndarray) -> tuple[list, int]:
    """Greedy acceptance along the tree from node 0: a child is taken where
    its token is the verify argmax at its parent. -> (the accepted nodes,
    node 0 first; the bonus token, the argmax at the last of them)."""
    node, nodes = 0, [0]
    while True:
        want = int(verify_argmax[node])
        nxt = next((c for c in tree.children(node) if int(tokens[c]) == want), None)
        if nxt is None:
            return nodes, want
        nodes.append(nxt)
        node = nxt


def greedy_accept(tree: Tree, tokens: np.ndarray, verify_argmax: np.ndarray):
    """Walk the tree accepting greedily. `verify_argmax` [N]: the base
    model's argmax at each node. Returns the accepted tokens (always >= 1:
    the base token) and the bonus token the model predicts after the last
    accepted node."""
    nodes, bonus = accept_nodes(tree, tokens, verify_argmax)
    return [int(tokens[n]) for n in nodes], bonus


def top_k_ids(logits: torch.Tensor, k: int) -> np.ndarray:
    """The indices of the k largest entries of a 1-d tensor, largest first,
    on the host (`jax.lax.top_k(...)[1]`)."""
    return torch.topk(logits, k).indices.cpu().numpy()


def tree_propose_and_verify(cfg: llama.LlamaConfig, params, medusa: dict, prompt: torch.Tensor,
                            tree: Optional[Tree] = None, steps: int = 16):
    """Greedy tree-speculative decode loop, one verify forward a block:
    -> (tokens [1, P + produced], acceptance_rate). The tokens are plain
    greedy decoding's."""
    from .medusa import medusa_logits

    tree = tree or build_tree()
    if prompt.shape[0] != 1:
        raise ValueError(f"the tree verifier is single-sequence, got batch {prompt.shape[0]}")
    dev = prompt.device
    tokens = prompt
    accepted_total = proposed_total = produced = 0
    k_needed = max(tree.choice) + 1
    while produced < steps:
        base_logits, head_logits = medusa_logits(cfg, params, medusa, tokens)
        base_tok = int(torch.argmax(base_logits[0, -1]))
        head_topk = np.stack([top_k_ids(head_logits[d][0, -1], k_needed) for d in range(tree.max_depth)])
        cand = assemble_candidates(tree, base_tok, head_topk)
        P = tokens.shape[1]
        seq = torch.cat([tokens, torch.from_numpy(cand[None, :]).to(device=dev, dtype=tokens.dtype)], dim=1)
        logits, _, _ = llama.forward(cfg, params, seq, positions=tree_position_ids(tree, P, dev),
                                     mask=tree_attention_mask(tree, P, dev))
        ver = torch.argmax(logits[0, P:], dim=-1).cpu().numpy()
        accepted, bonus = greedy_accept(tree, cand, ver)
        new = accepted + [bonus]
        tokens = torch.cat([tokens, torch.tensor([new], dtype=tokens.dtype, device=dev)], dim=1)
        produced += len(new)
        accepted_total += len(accepted) - 1
        proposed_total += tree.n_nodes - 1
    return tokens, accepted_total / max(proposed_total, 1)
