"""Histogram calibrator: percentile / MSE / entropy (KL) amax selection
(port of `quant/calib/histogram.py`).

Two passes, as in the JAX package: max calibration fixes the range, then a
fixed-bin histogram of |x| fills (a scatter-add of f32 counts) and the amax
is chosen from the final counts. `entropy_amax` runs in numpy on the host,
as JAX's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import linspace


@dataclasses.dataclass
class HistogramState:
    counts: torch.Tensor  # [num_bins] f32
    amax: torch.Tensor  # 0-d range (fixed after pass 1)


def init_histogram(range_amax, num_bins: int = 2048) -> HistogramState:
    """Empty counts over [0, range_amax] (a float, or a tensor on the device
    the counts live on)."""
    amax = torch.as_tensor(range_amax, dtype=torch.float32)
    return HistogramState(counts=torch.zeros((num_bins,), dtype=torch.float32, device=amax.device), amax=amax)


def collect_histogram(x: torch.Tensor, st: HistogramState) -> HistogramState:
    """Scatter |x| into fixed bins over [0, amax]."""
    nb = st.counts.shape[0]
    ax = torch.abs(x.float()).reshape(-1)
    idx = torch.clamp((ax / torch.clamp_min(st.amax, 1e-12) * nb).to(torch.int32), 0, nb - 1)
    counts = st.counts.index_add(0, idx.long(), torch.ones_like(ax))
    return HistogramState(counts=counts, amax=st.amax)


def percentile_amax(st: HistogramState, percentile: float = 99.99) -> torch.Tensor:
    """The amax covering `percentile`% of the observed magnitudes."""
    nb = st.counts.shape[0]
    cdf = torch.cumsum(st.counts, dim=0)
    target = cdf[-1] * (percentile / 100.0)
    idx = torch.clamp(torch.searchsorted(cdf, target.reshape(1)), 0, nb - 1)[0]
    return (idx.float() + 1.0) / nb * st.amax


def mse_amax(st: HistogramState, num_bits: int = 8, n_steps: int = 64) -> torch.Tensor:
    """The amax minimizing the expected INT-quant MSE over the histogram."""
    nb = st.counts.shape[0]
    centers = (torch.arange(nb, dtype=torch.float32, device=st.counts.device) + 0.5) / nb * st.amax
    bound = float(2 ** (num_bits - 1) - 1)
    ratios = linspace(0.25, 1.0, n_steps, st.counts.device)
    losses = []
    for r in ratios:
        scale = st.amax * r / bound
        q = torch.clamp(torch.round(centers / scale), -bound - 1, bound) * scale
        losses.append(torch.sum(st.counts * (q - centers) ** 2))
    return st.amax * ratios[torch.argmin(torch.stack(losses))]


def entropy_amax(st: HistogramState, num_bits: int = 8, start_frac: float = 0.125) -> torch.Tensor:
    """The KL-divergence-minimizing amax (TensorRT-style entropy
    calibration), every candidate bin swept, in numpy on the host."""
    counts = st.counts.cpu().numpy()
    nb = counts.shape[0]
    nlevels = 2 ** (num_bits - 1)
    full_range = float(st.amax)
    start = max(int(nb * start_frac), nlevels)
    best_kl, best_i = np.inf, nb
    p_full = counts.astype(np.float64)
    tail_from = np.concatenate([np.cumsum(p_full[::-1])[::-1], [0.0]])
    nzf = (p_full > 0).astype(np.float64)
    for i in range(start, nb + 1):
        p = p_full[:i].copy()
        p[i - 1] += tail_from[i]  # the clipped mass into the last bin
        psum = p.sum()
        if psum == 0:
            continue
        # nlevels equal-width buckets: each kept bin takes its bucket's mean
        # over the bucket's nonzero bins
        edges = (np.arange(nlevels, dtype=np.float64) * (i / nlevels)).astype(int)
        sums = np.add.reduceat(p, edges)
        nz = np.add.reduceat(nzf[:i], edges)
        if p[i - 1] > 0 and p_full[i - 1] == 0:
            nz[-1] += 1  # the tail mass made the last bin nonzero
        seg_lens = np.diff(np.append(edges, i))
        q_full = np.repeat(sums / np.maximum(nz, 1.0), seg_lens)
        q = np.where(p > 0, q_full, 0.0)
        pn = p / psum
        qn = q / max(q.sum(), 1e-12)
        mask = pn > 0
        kl = float(np.sum(pn[mask] * np.log(pn[mask] / np.maximum(qn[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return torch.tensor(np.float32(best_i / nb * full_range), dtype=torch.float32, device=st.amax.device)


def compute_amax(st: HistogramState, method: str = "percentile", percentile: float = 99.99,
                 num_bits: int = 8) -> torch.Tensor:
    if method == "percentile":
        return percentile_amax(st, percentile)
    if method == "mse":
        return mse_amax(st, num_bits)
    if method == "entropy":
        return entropy_amax(st, num_bits)
    if method == "max":
        return st.amax
    raise ValueError(f"unknown histogram method {method!r}")
