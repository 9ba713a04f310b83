"""FAST corner score, NMS and spatially-uniform keypoint selection.

Port of orb_slam_system_tpu/ops/fast.py (reference
ORBextractor::ComputeKeyPointsOctTree + DistributeOctTree). The dense score
map is the exact FAST-9 threshold of every pixel (corner at t <=> score > t),
so one map serves both thresholds (20, then 7 in cells without a strong
corner) and the NMS. Selection ranks candidates per 16-pixel cell, then
takes a per-level top-n with cells covered first.

Kernel A (`fast_score_nms`, csrc/fast_score_nms.cu) computes score + border
mask + 3x3 NMS in one pass on the card; `fast_score_map` and `nms3x3` are
its plain PyTorch version, used for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam_system_tpu_torch.utils import kernels

# Bresenham circle of radius 3: 16 (dy, dx) offsets in circular order
# (same circle OpenCV's FAST_9_16 uses).
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9: contiguous arc of >= 9 circle pixels
CELL = 16          # selection grid cell (pixels)
TOPK_PER_CELL = 4  # candidates kept per cell


def fast_score_map(img: torch.Tensor, border: int) -> torch.Tensor:
    """Dense FAST-9 corner score. img: f32[B,H,W] -> score f32[B,H,W].

    score(p) = max over the 32 (16 bright + 16 dark) circular arcs of length
    9 of the min ring-vs-center difference. Border pixels score 0."""
    _, H, W = img.shape
    ring = torch.stack([torch.roll(img, shifts=(-int(dy), -int(dx)),
                                   dims=(1, 2)) for dy, dx in CIRCLE])
    bright = ring - img[None]            # ring brighter than center
    # Circular windowed min/max of length 9 along the ring axis.
    ext = torch.cat([bright, bright[:ARC_LEN - 1]], dim=0)
    win = ext.unfold(0, ARC_LEN, 1)      # [16, B, H, W, 9]
    min_b = win.amin(dim=-1)
    min_d = -win.amax(dim=-1)            # min of the dark diffs (-bright)
    score = torch.maximum(min_b.amax(dim=0), min_d.amax(dim=0))
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    return torch.where(inb[None], score, torch.zeros((), device=img.device))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (-inf padding): keep pixels >= their
    neighborhood max. score: f32[B,H,W]."""
    pooled = F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where(score >= pooled, score, torch.zeros((), device=score.device))


def fast_score_nms(img: torch.Tensor, border: int) -> torch.Tensor:
    """nms3x3(fast_score_map(img, border)): kernel A on a CUDA tensor, the
    plain version on a CPU tensor."""
    if img.device.type == "cpu":
        return nms3x3(fast_score_map(img, border))
    kernels.check_cuda(img, "fast_score_nms img", torch.float32, 3)
    B, H, W = img.shape
    out = torch.empty_like(img)
    kernels.launch("orb_fast_score_nms", "fast_score_nms",
                   img.data_ptr(), out.data_ptr(), B, H, W, int(border))
    return out


def _cell_candidates(score, ini_th, min_th, cell, topk_per_cell):
    """NMS'd score map -> per-cell top-K candidates.

    Returns (vals f32[B,C,K], idx i64[B,C,K] in-cell flat position, hc, wc)."""
    B, H, W = score.shape
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    s = F.pad(score, (0, Wp - W, 0, Hp - H))
    hc, wc = Hp // cell, Wp // cell
    cells = s.reshape(B, hc, cell, wc, cell).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(B, hc * wc, cell * cell)
    # Weak corners count only in cells with no strong corner.
    has_strong = cells.amax(dim=-1, keepdim=True) > ini_th
    eligible = torch.where(has_strong, cells > ini_th, cells > min_th)
    zero = torch.zeros((), device=score.device)
    remaining = torch.where(eligible, cells, zero)
    pos = torch.arange(cell * cell, device=score.device)
    big = torch.full((), 1 << 20, device=score.device, dtype=torch.int64)
    ninf = torch.full((), -float("inf"), device=score.device)
    vals_l, idx_l = [], []
    for _ in range(topk_per_cell):
        m = remaining.amax(dim=-1)                             # [B, C]
        # Lowest index among ties (lax.top_k's order).
        am = torch.where(remaining == m[..., None], pos, big).amin(dim=-1)
        vals_l.append(m)
        idx_l.append(am)
        remaining = torch.where(pos == am[..., None], ninf, remaining)
    return torch.stack(vals_l, -1), torch.stack(idx_l, -1), hc, wc


def _order_key(vals, topk_per_cell):
    """Global candidate ordering: cover cells first (rank 0 of every cell),
    then rank 1, etc.; inside a rank order by response."""
    rank = torch.arange(topk_per_cell, dtype=torch.float32,
                        device=vals.device).reshape((1,) * (vals.dim() - 1) + (-1,))
    smax = vals.amax() + 1.0
    return torch.where(vals > 0.0, -rank * smax + vals,
                       torch.full((), -float("inf"), device=vals.device))


def _top_n(key: torch.Tensor, n: int):
    """lax.top_k(key, n) over the last axis: descending, ties lower index
    first (a stable sort; torch.topk promises no tie order). When n exceeds
    the candidate count the result is padded with -inf keys (index 0) instead
    of failing."""
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    m = key.shape[-1]
    if n <= m:
        return vals[..., :n], idx[..., :n]
    pad = n - m
    vals = F.pad(vals, (0, pad), value=-float("inf"))
    idx = F.pad(idx, (0, pad), value=0)
    return vals, idx


def _decode_selection(flat_idx, top_vals, vals, idx, wc, cell, topk_per_cell):
    """Selected flat candidate indices -> (xy i64[B,n,2], resp, valid)."""
    B = flat_idx.shape[0]
    cell_idx = flat_idx // topk_per_cell
    in_cell = torch.gather(idx.reshape(B, -1), 1, flat_idx)
    resp = torch.gather(vals.reshape(B, -1), 1, flat_idx)
    py = (cell_idx // wc) * cell + in_cell // cell
    px = (cell_idx % wc) * cell + in_cell % cell
    valid = (resp > 0.0) & torch.isfinite(top_vals)
    xy = torch.stack([px, py], dim=-1)
    xy = torch.where(valid[..., None], xy, torch.zeros_like(xy))
    return xy, resp, valid


def select_keypoints_multi(scores, budgets, ini_th: float, min_th: float):
    """Per-level keypoint selection from NMS'd score maps (the TOPK_SELECT
    branch of the JAX package's select_keypoints_multi).

    scores: list of f32[B,Hl,Wl]; budgets: per-level n_max. Returns per-level
    lists (xy i64[B,n_l,2] as (x, y), resp f32[B,n_l], valid bool[B,n_l])."""
    out = []
    for s, n_max in zip(scores, budgets):
        vals, idx, _, wc = _cell_candidates(s, ini_th, min_th, CELL,
                                            TOPK_PER_CELL)
        key = _order_key(vals, TOPK_PER_CELL).reshape(s.shape[0], -1)
        top_vals, flat_idx = _top_n(key, n_max)
        out.append(_decode_selection(flat_idx, top_vals, vals, idx, wc, CELL,
                                     TOPK_PER_CELL))
    return out
