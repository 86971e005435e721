"""Band-split projections as grouped batched products (counterpart of
sesa_tpu/ops/bands.py).

Bands of equal width are stacked and run as one batched product per width
group (7 groups for the default BS layout) instead of ~62 per-band Linears.
A band layout is a list of int32 feature-index arrays into the packed
(freq·stereo·complex) feature axis; mask reassembly inverts the packing by
a gather.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from sesa_tpu_torch import to_device
from sesa_tpu_torch.models.layers import kaiming_uniform, rms_norm


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Static plan: width groups over a band layout."""

    num_bands: int
    num_features: int
    group_band_ids: tuple  # tuple[tuple[int, ...]]
    group_feat_idx: tuple  # tuple[np.ndarray (m, w) int32]
    band_perm: np.ndarray  # (num_bands,) group-stacked order -> band order
    scatter_feats: np.ndarray  # (sum m*w,) feature index per stacked output
    coverage: np.ndarray  # (num_features,) float32 bands per feature
    # (num_features, max coverage) stacked outputs that land on each feature,
    # padded with len(scatter_feats); column 0 of a partition inverts the packing
    gather_idx: np.ndarray


def make_band_plan(band_feats: Sequence[np.ndarray], num_features: int) -> BandPlan:
    """Group a per-band feature-index layout by band width."""
    order: dict = {}
    for i, f in enumerate(band_feats):
        order.setdefault(len(f), []).append(i)
    group_band_ids = tuple(tuple(v) for v in order.values())
    group_feat_idx = tuple(
        np.stack([np.asarray(band_feats[i], dtype=np.int32) for i in ids])
        for ids in order.values())
    stacked_order = np.concatenate([np.asarray(ids) for ids in group_band_ids])
    scatter_feats = np.concatenate([idx.reshape(-1) for idx in group_feat_idx])
    coverage = np.zeros(num_features, dtype=np.float32)
    np.add.at(coverage, scatter_feats, 1.0)
    # slot of each stacked output among those landing on its feature, in
    # stacked order
    by_feat = np.argsort(scatter_feats, kind="stable")
    feats_sorted = scatter_feats[by_feat]
    slot = np.arange(len(by_feat)) - np.searchsorted(feats_sorted, feats_sorted, side="left")
    gather_idx = np.full((num_features, max(int(coverage.max()), 1)), len(by_feat), np.int64)
    gather_idx[feats_sorted, slot] = by_feat
    return BandPlan(
        num_bands=len(band_feats),
        num_features=num_features,
        group_band_ids=group_band_ids,
        group_feat_idx=group_feat_idx,
        band_perm=np.argsort(stacked_order).astype(np.int32),
        scatter_feats=scatter_feats.astype(np.int32),
        coverage=coverage,
        gather_idx=gather_idx,
    )


def contiguous_band_feats(widths: Sequence[int]) -> List[np.ndarray]:
    """Contiguous partition layout (BS-RoFormer's freqs_per_bands_with_complex)."""
    feats, off = [], 0
    for w in widths:
        feats.append(np.arange(off, off + w, dtype=np.int32))
        off += w
    return feats


def _index(idx, device) -> torch.Tensor:
    return to_device(np.asarray(idx, dtype=np.int64), device)


# --------------------------------------------------------------------------
# band split: per-band RMSNorm + Linear -> (B, T, NB, D)
# --------------------------------------------------------------------------

def band_split_init(generator: torch.Generator, plan: BandPlan, dim: int):
    groups = []
    for idx in plan.group_feat_idx:
        m, w = idx.shape
        groups.append({
            "norm_gamma": torch.ones((m, w)),
            "weight": kaiming_uniform((m, w, dim), w, generator),
            "bias": kaiming_uniform((m, dim), w, generator),
        })
    return {"groups": groups}


def band_split_apply(plan: BandPlan, params, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, F2) -> (B, T, NB, D)."""
    outs = []
    for g, idx in enumerate(plan.group_feat_idx):
        m, w = idx.shape
        p = params["groups"][g]
        xg = x.index_select(-1, _index(idx.reshape(-1), x.device))
        xg = rms_norm(xg.reshape(x.shape[:-1] + (m, w)), p["norm_gamma"])
        outs.append(torch.einsum("btmw,mwd->btmd", xg, p["weight"]) + p["bias"])
    stacked = torch.cat(outs, dim=2)
    if not np.array_equal(plan.band_perm, np.arange(plan.num_bands)):
        stacked = stacked.index_select(2, _index(plan.band_perm, x.device))
    return stacked


# --------------------------------------------------------------------------
# mask estimator: per-band MLP + GLU -> packed feature mask (B, T, F2)
# --------------------------------------------------------------------------

def mask_estimator_init(generator: torch.Generator, plan: BandPlan, dim: int,
                        n_hidden: int, expansion: int = 4):
    """``n_hidden`` hidden Linear+Tanh layers before the final GLU Linear."""
    hidden = dim * expansion
    params = {"hidden": []}
    d_in = dim
    for _ in range(n_hidden):
        params["hidden"].append({
            "weight": kaiming_uniform((plan.num_bands, d_in, hidden), d_in, generator),
            "bias": kaiming_uniform((plan.num_bands, hidden), d_in, generator),
        })
        d_in = hidden
    params["groups"] = [
        {"weight": kaiming_uniform((idx.shape[0], d_in, 2 * idx.shape[1]), d_in, generator),
         "bias": kaiming_uniform((idx.shape[0], 2 * idx.shape[1]), d_in, generator)}
        for idx in plan.group_feat_idx]
    return params


def mask_estimator_apply(plan: BandPlan, params, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, NB, D) -> (B, T, F2) mask over packed RI features.

    Overlapping bands (the mel layouts) are averaged by coverage; for a
    partition (BS-RoFormer) that is one permutation."""
    h = x
    for layer in params["hidden"]:
        h = torch.tanh(torch.einsum("btnd,ndh->btnh", h, layer["weight"]) + layer["bias"])

    flats = []
    for g, idx in enumerate(plan.group_feat_idx):
        m, w = idx.shape
        p = params["groups"][g]
        hg = h.index_select(2, _index(plan.group_band_ids[g], x.device))
        og = torch.einsum("btmd,mdw->btmw", hg, p["weight"]) + p["bias"]
        a, b = og.chunk(2, dim=-1)  # GLU
        flats.append((a * torch.sigmoid(b)).reshape(x.shape[:2] + (m * w,)))
    flat = torch.cat(flats, dim=-1)

    if np.all(plan.coverage == 1.0):
        # a partition: invert the band packing with one permutation
        return flat.index_select(-1, _index(plan.gather_idx[:, 0], x.device))
    # overlapping bands: per-feature gather-sum over the padded index table,
    # whose empty slots point at an appended zero column, then / coverage
    flatz = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (1,))], dim=-1)
    out = flatz.index_select(-1, _index(plan.gather_idx.reshape(-1), x.device))
    out = out.reshape(flat.shape[:-1] + plan.gather_idx.shape).sum(-1)
    cov = to_device(np.maximum(plan.coverage, 1e-8), x.device)
    return out / cov
