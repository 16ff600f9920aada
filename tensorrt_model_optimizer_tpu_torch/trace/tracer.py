"""Dimension-group tracing: derive prunable-dimension groups from a traced
forward (port of `trace/tracer.py`).

JAX's tracer walks the jaxpr of `forward(params, tokens)`; this one walks
the aten graph that `torch.fx.experimental.proxy_tensor.make_fx` records of
the same call (`pre_dispatch=True`, so `einsum`, `matmul` and
`repeat_interleave` stay whole, as JAX's `dot_general` and `jnp.repeat`
do). It unifies (param-path, axis) slots whose sizes an op forces equal:

 - `matmul` / `einsum` unify contracting and batch axes of
   their operands; the other axes flow through to the output.
 - Pointwise ops (`torch.Tag.pointwise`) zip same-size axes, broadcast
   right-aligned (size-1 axes never unify); other ops zip only where every
   operand has the output's rank, JAX's default; comparisons and tensor
   factories carry no labels.
 - `view` / `reshape` record a single axis split into two, or two adjacent
   axes merged, as a product relation `parent = left x right` (GQA: q heads
   against kv heads); `repeat_interleave` is such a merge, as JAX's
   `jnp.repeat` is.
 - `index` (the embedding lookup) carries the table's remaining axes.
 - Unknown ops leave their outputs unlabelled: they never merge groups.

Depth: JAX's `depth` group is the leading axis of every stack a `lax.scan`
runs over. The port loops over layers in Python, so a forward marks the
stack that JAX scans with `scanned(tree)` (the identity; the tracer sees it
and puts the leaves' leading axes in one depth group per call). Mamba's
forward walks its pattern in Python in both packages and marks nothing, so
neither derives a depth group there.

Output: {"groups": [DerivedGroup], "ungrouped": [(path, axis)],
"relations": [(parent, left, right)]}, named from `cfg`'s integer
attributes as JAX names them. Groups are listed, and groups that share a
name numbered, in the order of their union-find roots' reprs, as JAX's; the
roots are not the same nodes in the two graphs, so the list order may part
(ROADMAP queue 3).
"""

from __future__ import annotations

import contextvars
import dataclasses
import operator
from typing import Any, Callable, Optional

import torch

_SCANS: contextvars.ContextVar = contextvars.ContextVar("trace_scans", default=None)


def scanned(tree):
    """Mark `tree` (a dict of stacked [L, ...] tensors) as the stack the JAX
    package runs through `lax.scan`; the identity outside a trace."""
    scans = _SCANS.get()
    if scans is not None:
        leaves = []

        def walk(t):
            if isinstance(t, torch.Tensor):
                leaves.append(id(t))
            elif isinstance(t, dict):
                for v in t.values():
                    walk(v)

        walk(tree)
        scans.append(leaves)
    return tree


_TIES: contextvars.ContextVar = contextvars.ContextVar("trace_ties", default=None)


def tied(tensors, axis: int = 0) -> None:
    """Mark `axis` of `tensors` as one axis of the JAX package's computation
    where the port loops over it (the experts' axis, a batch dim of JAX's
    dispatch einsums); the unions run in list order. A no-op outside a
    trace."""
    ties = _TIES.get()
    if ties is None:
        return
    from torch.fx.experimental import proxy_tensor

    mode = proxy_tensor.get_proxy_mode()
    ties.append(([proxy_tensor.get_proxy_slot(t, mode.tracer).proxy.node for t in tensors], axis))


# --------------------------------------------------------------------------
# union-find over (param-path, axis) nodes
# --------------------------------------------------------------------------


class _UF:
    def __init__(self):
        self.parent: dict = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        if p != x:
            self.parent[x] = p = self.find(p)
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


@dataclasses.dataclass(frozen=True)
class DerivedGroup:
    """A dimension class: every (param path, axis) slot tied to one size.
    `coupled` lists slots related by a product (q_proj's head axis = ratio x
    this group) rather than by equality."""

    name: str
    size: int
    sites: tuple[tuple[str, int], ...]
    coupled: tuple[tuple[str, int], ...] = ()


# An axis label is a frozenset of nodes: ("path", axis) for a param leaf,
# ("~synth", n) for an axis a split or merge made.
_EMPTY = frozenset()


def _zip_elementwise(uf, in_labels, shapes, out_shape):
    """Unify same-position (right-aligned), same-size (> 1) axes of the
    operands; an output axis's label is the union of its inputs'."""
    out = []
    rank = len(out_shape)
    for ax in range(rank):
        merged: set = set()
        first = None
        for labels, shape in zip(in_labels, shapes):
            iax = ax - (rank - len(shape))
            if iax < 0 or shape[iax] != out_shape[ax] or out_shape[ax] == 1:
                continue
            lab = labels[iax]
            if lab:
                if first is None:
                    first = next(iter(lab))
                for n in lab:
                    uf.union(first, n)
                merged |= lab
        out.append(frozenset(merged))
    return tuple(out)


def _empty(shape) -> tuple:
    return tuple(_EMPTY for _ in shape)


def _shape(v) -> Optional[tuple]:
    return tuple(v.shape) if isinstance(v, torch.Tensor) else None


# tensor factories and comparisons: outputs without labels, as JAX's iota / eq / lt / ...
_NO_LABELS = {"arange", "zeros", "ones", "full", "zeros_like", "full_like", "lift_fresh_copy",
              "eq", "lt", "gt", "le", "ge"}
_REDUCE = {"sum", "mean", "amax", "amin", "argmax", "argmin"}


class _Tracer:
    def __init__(self):
        self.uf = _UF()
        self.relations: list[tuple] = []  # (parent, left, right, lsize, rsize)
        self._synth = 0

    def synth(self):
        self._synth += 1
        return ("~synth", self._synth)

    def rep(self, label):
        return self.uf.find(next(iter(label))) if label else None

    def label_union(self, *labels):
        out, first = set(), None
        for lab in labels:
            for n in lab:
                if first is None:
                    first = n
                self.uf.union(first, n)
                out.add(n)
        return frozenset(out)

    # ---- the graph walk ----------------------------------------------------

    def walk(self, graph, in_labels: dict):
        env: dict = {}
        for node in graph.nodes:
            val = node.meta.get("val")
            if node.op == "placeholder":
                env[node] = in_labels.get(node.name) or (_empty(val.shape) if isinstance(val, torch.Tensor) else ())
            elif node.op == "call_function":
                env[node] = self.rule(node, env)
        return env

    def _args(self, node, env):
        """(labels, shape) of the node's tensor arguments, in order."""
        out = []

        def add(a):
            if isinstance(a, torch.fx.Node) and isinstance(a.meta.get("val"), torch.Tensor):
                out.append((env.get(a) or _empty(a.meta["val"].shape), tuple(a.meta["val"].shape)))
            elif isinstance(a, (list, tuple)):
                for x in a:
                    add(x)

        for a in node.args:
            add(a)
        return out

    def rule(self, node, env):
        val = node.meta.get("val")
        target = node.target
        if target is operator.getitem:
            src, i = node.args
            labs = env.get(src)
            return labs[i] if isinstance(labs, list) and i < len(labs) else (
                _empty(val.shape) if isinstance(val, torch.Tensor) else ())
        name = getattr(target, "__name__", str(target)).split(".")[0]
        if isinstance(val, (tuple, list)):  # multi-output ops (topk, max.dim, ...): each output zipped
            args = self._args(node, env)
            return [self._elementwise(args, tuple(v.shape)) if isinstance(v, torch.Tensor) else ()
                    for v in val]
        if not isinstance(val, torch.Tensor):
            return ()
        out_shape = tuple(val.shape)
        args = self._args(node, env)
        if name in _NO_LABELS or not args:
            return _empty(out_shape)
        labs, shapes = [a[0] for a in args], [a[1] for a in args]
        fn = getattr(self, "_op_" + name, None)
        if fn is not None:
            return fn(node, labs, shapes, out_shape)
        if name in _REDUCE:
            return self._reduce(node, labs[0], shapes[0], out_shape)
        return self._elementwise(args, out_shape, torch.Tag.pointwise in getattr(target, "tags", ()))

    def _elementwise(self, args, out_shape, broadcasting: bool = False):
        """Pointwise ops broadcast (operands of lower rank, right-aligned);
        any other op is zipped only where every operand has the output's
        rank (or none), JAX's default rule."""
        if all(len(s) == len(out_shape) or len(s) == 0 or (broadcasting and len(s) < len(out_shape))
               for _, s in args):
            return _zip_elementwise(self.uf, [a[0] for a in args], [a[1] for a in args], out_shape)
        return _empty(out_shape)

    def _reduce(self, node, lab, shape, out_shape):
        dims = node.args[1] if len(node.args) > 1 else None
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            dims = range(len(shape))
        dims = {d % len(shape) for d in ([dims] if isinstance(dims, int) else dims)}
        if len(out_shape) == len(shape):  # keepdim
            return tuple(_EMPTY if i in dims else l for i, l in enumerate(lab))
        return tuple(l for i, l in enumerate(lab) if i not in dims)

    # ---- structural rules --------------------------------------------------

    def _contract(self, operands: list, out_letters: str):
        """Einsum over labelled operands [(letters, labels)]: every letter's
        labels unified across the operands that have it (contracting and
        batch axes alike); an output letter's label is the union."""
        by_letter: dict = {}
        for letters, labs in operands:
            for ch, lab in zip(letters, labs):
                by_letter.setdefault(ch, []).append(lab)
        out = []
        for ch in set(by_letter):
            labs = [l for l in by_letter[ch] if l]
            if len(by_letter[ch]) > 1 and len(labs) > 1:
                first = next(iter(labs[0]))
                for l in labs[1:]:
                    self.uf.union(first, next(iter(l)))
        for ch in out_letters:
            out.append(self.label_union(*by_letter.get(ch, [])) if len(by_letter.get(ch, [])) > 1
                       else (by_letter[ch][0] if ch in by_letter else _EMPTY))
        return tuple(out)

    def _op_einsum(self, node, labs, shapes, out_shape):
        eq = node.args[0].replace(" ", "")
        lhs, out_letters = eq.split("->")
        specs = lhs.split(",")
        if any("." in s for s in specs) or len(specs) != len(labs):
            return _empty(out_shape)
        return self._contract(list(zip(specs, labs)), out_letters)

    def _matmul(self, labs, shapes, out_shape):
        (la, lb), (sa, sb) = labs[:2], shapes[:2]
        if len(sa) < 2 or len(sb) < 2:
            return _empty(out_shape)
        if la[-1] and lb[-2]:
            self.uf.union(next(iter(la[-1])), next(iter(lb[-2])))
        nb = len(out_shape) - 2
        batch = _zip_elementwise(self.uf, [la[:-2], lb[:-2]], [sa[:-2], sb[:-2]], tuple(out_shape[:nb]))
        return tuple(batch) + (la[-2], lb[-1])

    def _op_matmul(self, node, labs, shapes, out_shape):
        return self._matmul(labs, shapes, out_shape)

    def _op_t(self, node, labs, shapes, out_shape):
        return tuple(reversed(labs[0]))

    def _op_permute(self, node, labs, shapes, out_shape):
        return tuple(labs[0][d % len(labs[0])] for d in node.args[1])

    def _op_reshape(self, node, labs, shapes, out_shape):
        return self._reshape(labs[0], shapes[0], out_shape)

    def _op_expand(self, node, labs, shapes, out_shape):
        lab, shape = labs[0], shapes[0]
        off = len(out_shape) - len(shape)
        out = [_EMPTY] * len(out_shape)
        for i, s in enumerate(shape):
            if s == out_shape[i + off] and s != 1:
                out[i + off] = lab[i]
        return tuple(out)

    def _op_unsqueeze(self, node, labs, shapes, out_shape):
        d = node.args[1] % len(out_shape)
        lab = list(labs[0])
        return tuple(lab[:d] + [_EMPTY] + lab[d:])

    def _op_select(self, node, labs, shapes, out_shape):
        d = node.args[1] % len(shapes[0])
        return tuple(l for i, l in enumerate(labs[0]) if i != d)

    def _op_slice(self, node, labs, shapes, out_shape):
        return tuple(l if s == o else _EMPTY for l, s, o in zip(labs[0], shapes[0], out_shape))

    def _op_cat(self, node, labs, shapes, out_shape):
        dim = (node.args[1] if len(node.args) > 1 else 0) % len(out_shape)
        out = list(_zip_elementwise(self.uf, labs, shapes, out_shape))
        out[dim] = _EMPTY  # the concat axis is a sum, not an equality
        return tuple(out)

    def _op_stack(self, node, labs, shapes, out_shape):
        """jnp.stack's expand_dims + concatenate: the inputs zipped."""
        dim = (node.args[1] if len(node.args) > 1 else 0) % len(out_shape)
        inner = list(_zip_elementwise(self.uf, labs, shapes, shapes[0]))
        return tuple(inner[:dim] + [_EMPTY] + inner[dim:])

    def _op_index(self, node, labs, shapes, out_shape):
        """Advanced indexing a[..., idx, ...] with one contiguous block of
        index tensors: the table's other axes keep their labels (the
        embedding lookup); the index's axes carry none."""
        idx = node.args[1]
        pos = [i for i, t in enumerate(idx) if t is not None]
        lab = labs[0]
        if not pos or pos != list(range(pos[0], pos[0] + len(pos))):
            return _empty(out_shape)
        n_idx = len(out_shape) - (len(lab) - len(pos))
        return tuple(lab[:pos[0]]) + (_EMPTY,) * n_idx + tuple(lab[pos[-1] + 1:])

    def _op_repeat_interleave(self, node, labs, shapes, out_shape):
        """jnp.repeat's broadcast + merge: the axis becomes (axis x rep)."""
        if len(node.args) < 3 or not isinstance(node.args[1], int):
            return _empty(out_shape)
        d = node.args[2] % len(shapes[0])
        lab = list(labs[0])
        ln = self.rep(lab[d]) or self.synth()
        rn, mn = self.synth(), self.synth()
        self.relations.append((mn, ln, rn, shapes[0][d], node.args[1]))
        lab[d] = frozenset([mn])
        return tuple(lab)

    def _op_copy_(self, node, labs, shapes, out_shape):
        """In-place writes keep the destination's labels (JAX's
        dynamic_update_slice rule)."""
        return tuple(labs[0])

    _op_index_copy_ = _op_scatter_ = _op_copy_

    def _reshape(self, labels, src, dst):
        """Split / merge with product relations; unchanged prefix and suffix
        axes keep their labels."""
        src, dst = tuple(src), tuple(dst)
        if src == dst:
            return tuple(labels)
        pre = 0
        while pre < min(len(src), len(dst)) and src[pre] == dst[pre]:
            pre += 1
        suf = 0
        while suf < min(len(src), len(dst)) - pre and src[len(src) - 1 - suf] == dst[len(dst) - 1 - suf]:
            suf += 1
        mid_src, mid_dst = src[pre:len(src) - suf], dst[pre:len(dst) - suf]
        out = list(labels[:pre])
        if len(mid_src) == 1 and len(mid_dst) == 2:  # split: parent = left x right
            parent = labels[pre]
            ln, rn = self.synth(), self.synth()
            if parent:
                self.relations.append((self.rep(parent), ln, rn, mid_dst[0], mid_dst[1]))
            core = [frozenset([ln]), frozenset([rn])]
        elif len(mid_src) == 2 and len(mid_dst) == 1:  # merge: new = left x right
            ln = self.rep(labels[pre]) or self.synth()
            rn = self.rep(labels[pre + 1]) or self.synth()
            mn = self.synth()
            self.relations.append((mn, ln, rn, mid_src[0], mid_src[1]))
            core = [frozenset([mn])]
        else:
            core = [_EMPTY for _ in mid_dst]
        return tuple(out + core + list(labels[len(src) - suf:]))


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def _flatten(params) -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) in torch's pytree order, paths as JAX's `keystr(simple=
    True, separator="/")`."""
    out = []

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        elif isinstance(t, torch.Tensor):
            out.append((prefix, t))

    walk(params, "")
    return out


def trace_dim_groups(forward: Callable, params: dict, cfg: Any = None, *,
                     example_tokens: Optional[torch.Tensor] = None) -> dict:
    """Trace `forward(params, tokens)` (on the params' device) and derive
    dimension groups -> {"groups", "ungrouped", "relations"} (see the module
    docstring)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    flat = _flatten(params)
    dev = flat[0][1].device if flat else torch.device("cpu")
    if example_tokens is None:
        example_tokens = torch.zeros((2, 8), dtype=torch.int32, device=dev)

    scans: list = []
    ties: list = []
    tokens = (_SCANS.set(scans), _TIES.set(ties))
    try:
        with torch.no_grad():
            gm = make_fx(lambda p: forward(p, example_tokens), pre_dispatch=True)(params)
    finally:
        _SCANS.reset(tokens[0])
        _TIES.reset(tokens[1])

    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(placeholders) != len(flat):
        raise ValueError(f"traced {len(placeholders)} inputs for {len(flat)} parameter leaves")
    tr = _Tracer()
    in_labels = {}
    path_of_id = {}
    for node, (path, leaf) in zip(placeholders, flat):
        in_labels[node.name] = tuple(frozenset([(path, ax)]) for ax in range(leaf.ndim))
        path_of_id[id(leaf)] = path
    env = tr.walk(gm.graph, in_labels)
    for nodes, axis in ties:
        first = None
        for n in nodes:
            for lab in env[n][axis]:
                if first is None:
                    first = lab
                tr.uf.union(first, lab)

    depth_nodes = []
    for i, leaves in enumerate(scans):  # one depth group per scanned stack (JAX: per lax.scan)
        node = ("~depth", i + 1)
        depth_nodes.append(node)
        for path in sorted(path_of_id[lid] for lid in leaves if lid in path_of_id):  # JAX's sorted leaves
            tr.uf.union(node, (path, 0))

    # product-relation congruence to a fixpoint: unified parents with equal
    # factor sizes have unified factors (downward), unified factor pairs
    # unified parents (upward)
    changed = True
    while changed:
        changed = False
        by_parent: dict = {}
        by_factors: dict = {}
        for p, l, r, ls, rs in tr.relations:
            p, l, r = tr.uf.find(p), tr.uf.find(l), tr.uf.find(r)
            lr = by_parent.setdefault((p, ls, rs), (l, r))
            if lr != (l, r):
                tr.uf.union(lr[0], l)
                tr.uf.union(lr[1], r)
                changed = True
                break
            q = by_factors.setdefault((l, r, ls, rs), p)
            if q != p:
                tr.uf.union(q, p)
                changed = True
                break

    by_root: dict = {}
    sizes: dict = {}
    for path, leaf in flat:
        for ax in range(leaf.ndim):
            by_root.setdefault(tr.uf.find((path, ax)), []).append((path, ax))
            sizes[(path, ax)] = leaf.shape[ax]

    rel_roots = [(tr.uf.find(p), tr.uf.find(l), tr.uf.find(r)) for p, l, r, _, _ in tr.relations]
    adj: dict = {}
    for p, l, r in rel_roots:
        for a, b in ((p, l), (p, r), (l, p), (r, p)):
            adj.setdefault(a, set()).add(b)
    coupled_of: dict = {}
    param_roots = set(by_root)
    for start in param_roots:
        if start not in adj:
            continue
        seen_n, frontier = {start}, [start]
        while frontier:
            cur = frontier.pop()
            for nxt in adj.get(cur, ()):
                if nxt not in seen_n:
                    seen_n.add(nxt)
                    frontier.append(nxt)
        for other in seen_n & param_roots - {start}:
            coupled_of.setdefault(start, set()).update(by_root[other])

    def group_name(size):
        if cfg is not None:
            for f in sorted(dir(cfg)):
                if f.startswith("_"):
                    continue
                try:
                    val = getattr(cfg, f)
                except Exception:  # a property that does not apply to this config
                    continue
                if isinstance(val, int) and not isinstance(val, bool) and val == size:
                    return f
        return f"dim{size}"

    depth_roots = {tr.uf.find(d) for d in depth_nodes}
    kept = [(root, sorted(members)) for root, members in by_root.items()
            if len(members) >= 2 or root in coupled_of or root in depth_roots]
    groups, taken = [], {}
    for root, members in sorted(kept, key=lambda rm: str(rm[0])):
        size = sizes[members[0]]
        name = "depth" if root in depth_roots else group_name(size)
        n = taken.get(name, 0)
        taken[name] = n + 1
        groups.append(DerivedGroup(name=f"{name}.{n}" if n else name, size=size, sites=tuple(members),
                                   coupled=tuple(sorted(coupled_of.get(root, ())))))
    grouped = {s for g in groups for s in g.sites}
    ungrouped = [(path, ax) for path, leaf in flat for ax in range(leaf.ndim) if (path, ax) not in grouped]
    return {"groups": groups, "ungrouped": ungrouped, "relations": rel_roots}
